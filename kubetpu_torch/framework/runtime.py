"""Framework runtime — compose filter/score kernels per profile.

Port of ``kubetpu/framework/runtime.py``, narrowed to the slices ported so
far: the default profile's cycle with inter-pod affinity, topology spread,
the nominator's reservations, the extender webhook's verdicts, the
topology coordinates the gang lane reads, the volume plugins' static rows
and DynamicResources (dense pool columns on the resource axis, host-claim
static rows and the prioritized-list score rows).
Host encode is the reference's numpy code, in its two stages
(``encode_batch_static``, then ``finalize_batch``); the device batch is a
frozen dataclass of torch tensors on the caller's device whose pod leaves
are uploaded in one host→device copy, and whose node block is either
shipped whole or kept resident on the device (``ResidentNodeState``),
which then takes only the dirty rows through the hand-written
``scatter_rows`` kernel (B5).

The analog of ``pkg/scheduler/framework/runtime/framework.go``: the reference
runs, per pod, PreFilter → parallel per-node Filter → PreScore → parallel
per-node Score → NormalizeScore → weight multiply → sum
(``RunScorePlugins``, framework.go:1351). Here the whole batch is one tensor
program: every enabled plugin contributes a ``(P, N)`` raw score tensor, the
runtime applies each plugin's NormalizeScore rule (masked to feasible nodes —
the reference only ever scores nodes that passed Filter), multiplies by the
profile weight, and sums into the total ``(P, N)`` score used for selection.

``feasible_and_scores`` / ``filter_score_batch`` here are the plain PyTorch
versions. ``filter_score_batch`` launches the hand-written ``filter_score``
kernel when the batch lives on a CUDA device.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from ..api import types as t
from ..ops import filters as F
from ..ops import podaffinity as PA
from ..ops.reduce import run_local
from ..ops import scores as S
from ..ops import spread as SP
from ..state import encoder as enc
from ..state import podaffinity as enc_podaffinity
from ..state import spread as enc_spread
from ..state.snapshot import Snapshot
from . import config as C


@dataclass(frozen=True)
class DeviceNodeState:
    """The persistent node-state block of a scheduling problem: everything
    on the node axis that survives from cycle to cycle."""

    alloc: torch.Tensor              # (N, R) int64
    requested: torch.Tensor          # (N, R) int64 exact
    nonzero_requested: torch.Tensor  # (N, R) int64 scoring view
    pod_count: torch.Tensor          # (N,) int32
    allowed_pods: torch.Tensor       # (N,) int32
    node_valid: torch.Tensor         # (N,) bool


@dataclass(frozen=True)
class PodAffinityDevice:
    """Device-side InterPodAffinity rows (see state.podaffinity)."""

    node_domain: torch.Tensor  # (R, N) int32
    has_key: torch.Tensor      # (R, N) bool
    base_sums: torch.Tensor    # (R, D) int64 — scan state init
    update: torch.Tensor       # (P, R) int64
    fa_rows: torch.Tensor      # (P, CA) int32
    fa_self: torch.Tensor      # (P,) bool
    ra_rows: torch.Tensor      # (P, CR) int32
    ea_rows: torch.Tensor      # (P, CE) int32
    score_rows: torch.Tensor   # (P, CS) int32
    score_vals: torch.Tensor   # (P, CS) int64
    has_filter_work: bool = False
    has_score_work: bool = False


PA_FIELDS = tuple(
    f.name for f in dataclasses.fields(PodAffinityDevice)
    if f.name not in ("has_filter_work", "has_score_work")
)


@dataclass(frozen=True)
class SpreadDevice:
    """Device-side spread tensors (see state.spread.SpreadTensors)."""

    eligible: torch.Tensor        # (S, N) bool
    node_domain: torch.Tensor     # (S, N) int32
    node_count: torch.Tensor      # (S, N) int32 — base counts (scan state init)
    has_key: torch.Tensor         # (S, N) bool
    domain_present: torch.Tensor  # (S, D) bool
    num_domains: torch.Tensor     # (S,) int32
    is_hostname: torch.Tensor     # (S,) bool
    sig_idx: torch.Tensor         # (P, C) int32
    action: torch.Tensor          # (P, C) int8
    max_skew: torch.Tensor        # (P, C) int32
    min_domains: torch.Tensor     # (P, C) int32
    self_match: torch.Tensor      # (P, C) int32
    pod_match_sig: torch.Tensor   # (P, S) bool
    ignored: torch.Tensor         # (P, N) bool
    has_hard: bool = False
    has_soft: bool = False


SP_FIELDS = tuple(
    f.name for f in dataclasses.fields(SpreadDevice)
    if f.name not in ("has_hard", "has_soft")
)


@dataclass(frozen=True)
class TopologyDevice:
    """Device-side dense topology coordinates (see state.topology)."""

    slice_id: torch.Tensor  # (N,) int32; value == num_slices ⇒ unlabeled
    rack_id: torch.Tensor   # (N,) int32; value == num_racks ⇒ unlabeled
    num_slices: int = 0
    num_racks: int = 0


# the leaves that hold their own dataclass of tensors: (class, tensor
# fields, static fields)
NESTED = {
    "podaffinity": (PodAffinityDevice, PA_FIELDS,
                    ("has_filter_work", "has_score_work")),
    "spread": (SpreadDevice, SP_FIELDS, ("has_hard", "has_soft")),
    "topology": (TopologyDevice, ("slice_id", "rack_id"),
                 ("num_slices", "num_racks")),
}
# static fields that are counts; every other static field is a flag
_COUNT_FIELDS = frozenset({"num_slices", "num_racks"})


@dataclass(frozen=True)
class DeviceBatch:
    """Padded device-resident scheduling problem: P pods × N nodes × R
    resources. Padding rows/cols are masked out (``node_valid``/``pod_valid``
    False, ``static_mask`` False on pads) so kernels need no special cases.

    Same field names and ``None`` leaves as the reference's pytree."""

    # persistent node-state block
    nodes: DeviceNodeState
    # pods
    requests: torch.Tensor           # (P, R) int64 exact
    nonzero_requests: torch.Tensor   # (P, R) int64
    pod_valid: torch.Tensor          # (P,) bool
    # static per-(pod,node) facts from the encoder, SIGNATURE-compressed:
    # (S, N) rows for S distinct pod signatures plus a per-pod (P,) row
    # index. None when the profile does not score that plugin / no pod has
    # a static constraint.
    static_mask: torch.Tensor | None        # (S, N) bool
    node_affinity_raw: torch.Tensor | None  # (S2, N) int64
    taint_prefer_raw: torch.Tensor | None   # (S2, N) int64
    image_sum_scores: torch.Tensor | None   # (S3, N) int64
    image_count: torch.Tensor | None        # (P,) int32
    # NodePorts dynamic filter (interned triples, see encoder._encode_ports)
    pod_ports: torch.Tensor          # (P, K) bool
    node_ports: torch.Tensor         # (N, K) bool
    port_conflict: torch.Tensor      # (K, K) bool
    # nominator reservations (queue.nominator), None without nominations
    nominated_node: torch.Tensor | None = None     # (G,) int32, -1 = none
    nominated_req: torch.Tensor | None = None      # (G, R) int64
    nominated_gate: torch.Tensor | None = None     # (P, G) bool
    nominated_ports: torch.Tensor | None = None    # (G, K) bool
    nominated_pod_idx: torch.Tensor | None = None  # (G,) int32, -1 = not in batch
    spread: SpreadDevice | None = None
    podaffinity: PodAffinityDevice | None = None
    static_sig: torch.Tensor | None = None  # (P,) int32 row into static_mask
    score_sig: torch.Tensor | None = None   # (P,) int32 row into na/tt raws
    image_sig: torch.Tensor | None = None   # (P,) int32 row into image sums
    # extender webhook verdicts for this cycle (sched/extender.py)
    extender_mask: torch.Tensor | None = None   # (P, N) bool
    extender_score: torch.Tensor | None = None  # (P, N) int64
    # DynamicResources prioritized-list raw score (dynamicresources.go:1059
    # computeScore), signature-compressed like the other static raws
    dra_score_raw: torch.Tensor | None = None   # (S5, N) int64
    dra_score_sig: torch.Tensor | None = None   # (P,) int32
    pod_priority: torch.Tensor | None = None     # (P,) int32
    # dense node-topology coordinates (state.topology): present only when
    # topology is ACTIVE (``topology="on"``, or ``"auto"`` with labeled
    # nodes)
    topology: TopologyDevice | None = None

    @property
    def alloc(self) -> torch.Tensor:
        return self.nodes.alloc

    @property
    def requested(self) -> torch.Tensor:
        return self.nodes.requested

    @property
    def nonzero_requested(self) -> torch.Tensor:
        return self.nodes.nonzero_requested

    @property
    def pod_count(self) -> torch.Tensor:
        return self.nodes.pod_count

    @property
    def allowed_pods(self) -> torch.Tensor:
        return self.nodes.allowed_pods

    @property
    def node_valid(self) -> torch.Tensor:
        return self.nodes.node_valid

    @property
    def device(self) -> torch.device:
        return self.nodes.alloc.device


NODE_FIELDS = tuple(f.name for f in dataclasses.fields(DeviceNodeState))
# a resident block's delta in the upload: the dirty rows' index, then their
# six rows (kernel B5's operands)
DELTA_FIELDS = ("delta.idx",) + tuple("delta." + n for n in NODE_FIELDS)
POD_FIELDS = tuple(
    f.name for f in dataclasses.fields(DeviceBatch) if f.name != "nodes"
)


# Every pod-indexed leaf that the filter_score kernel packs (the (P, ·)
# fields of ScoreArgs, kernels/csrc/score_common.cuh), by field path: two
# pods share a class (``PodClasses``) only if all of them are equal. The
# spread's (P, N) ``ignored`` row is keyed by the spread encoder's
# template id, from which it is built; the extender's (P, N) answers put
# every pod in a class of its own.
POD_CLASS_KEY = (
    "requests", "nonzero_requests", "pod_valid", "pod_ports", "static_sig", "score_sig",
    "image_sig", "image_count", "dra_score_sig", "nominated_gate",
    "extender_mask", "extender_score",
    "podaffinity.update", "podaffinity.fa_rows", "podaffinity.fa_self",
    "podaffinity.ra_rows", "podaffinity.ea_rows", "podaffinity.score_rows",
    "podaffinity.score_vals",
    "spread.sig_idx", "spread.action", "spread.max_skew", "spread.min_domains",
    "spread.self_match", "spread.pod_match_sig", "spread.ignored",
)


@dataclass(frozen=True)
class PodClasses:
    """A batch's P pods split into C classes whose pods are equal in every
    ``POD_CLASS_KEY`` leaf, so that the ``filter_score`` kernel scores one
    pod a class (its first, the class's representative) and copies its
    rows to the others. Classes are numbered by their first pod; class c's
    pods, ascending, are ``members[class_start[c]:class_start[c + 1]]``.
    ``reps`` (C,) and ``rep_of`` (P,) int32, each pod's representative, and
    ``class_idx`` (P,) int32, each pod's class (``class_of``), are the
    kernels' copies on the batch's device (None when every pod is a class
    of its own, where the kernels need none)."""

    class_of: np.ndarray     # (P,) int32
    class_start: np.ndarray  # (C + 1,) int32
    members: np.ndarray      # (P,) int32
    reps: torch.Tensor | None = None
    rep_of: torch.Tensor | None = None
    class_idx: torch.Tensor | None = None

    @property
    def count(self) -> int:
        return len(self.class_start) - 1

    @property
    def shared(self) -> bool:
        """Some class has more than one pod."""
        return self.count < len(self.class_of)

    def host_reps(self) -> np.ndarray:
        return self.members[self.class_start[:-1]]

    def host_rep_of(self) -> np.ndarray:
        return self.host_reps()[self.class_of]

    def rows(self, lo: int, hi: int) -> "PodClasses":
        """The classes of pods ``[lo, hi)`` alone (a pod row of a grid)."""
        return _classes_of_rows(self.class_of[lo:hi, None].astype(np.int64))


def _classes_of_rows(key: np.ndarray) -> PodClasses:
    """Classes of the equal rows of ``key`` (P, W) int64, numbered by first
    pod: a stable sort of the rows (ties keep pod order, so each run's
    first is its least pod), then a new class wherever a row differs from
    the one before."""
    P = key.shape[0]
    order = np.lexsort(key.T[::-1])
    ordered = key[order]
    new = np.ones(P, dtype=bool)
    np.any(ordered[1:] != ordered[:-1], axis=1, out=new[1:])
    run = np.cumsum(new) - 1
    first = order[new]
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    class_of = np.empty(P, dtype=np.int32)
    class_of[order] = rank[run]
    start = np.zeros(len(first) + 1, dtype=np.int32)
    np.cumsum(np.bincount(class_of, minlength=len(first)), out=start[1:])
    members = np.argsort(class_of, kind="stable").astype(np.int32)
    return PodClasses(class_of=class_of, class_start=start, members=members)


def _key_leaf(leaves: Mapping, path: str):
    parent, _, field = path.rpartition(".")
    if not parent:
        return leaves.get(field)
    obj = leaves.get(parent)
    return None if obj is None else getattr(obj, field, None)


def pod_classes_of(leaves: Mapping) -> PodClasses | None:
    """The pod classes of a batch's numpy leaves (``device_batch_from_numpy``'s
    names), on the host: the exact rows of every ``POD_CLASS_KEY`` leaf
    compared as int64 values, the spread's ``ignored`` through its template id
    (its rows compared whole when the leaf carries none, as kubetpu's
    does). None with extender leaves: every pod is then a class of its
    own."""
    if leaves.get("extender_mask") is not None or leaves.get("extender_score") is not None:
        return None
    P = int(np.shape(leaves["requests"])[0])
    if P == 0:
        return None
    cols = []
    for path in POD_CLASS_KEY:
        a = _key_leaf(leaves, path)
        if a is None:
            continue
        if path == "spread.ignored":
            tid = getattr(leaves["spread"], "template_id", None)
            a = np.packbits(np.asarray(a), axis=1) if tid is None else tid
        a = np.asarray(a)
        if a.dtype.kind not in "biu":
            # int64 holds every bool and integer value apart, not a float
            raise TypeError(f"pod class key: {path} is {a.dtype}, not an integer leaf")
        cols.append(a.reshape(P, -1).astype(np.int64))
    return _classes_of_rows(np.concatenate(cols, axis=1))


def pod_classes(b) -> PodClasses | None:
    """The classes the batch was built with (``device_batch_from_numpy``,
    ``shard_batch``), None when it carries none: a batch made any other
    way (a per-pod view, extender answers attached) is scored pod by pod."""
    return getattr(b, "_pod_classes", None)


def attach_pod_classes(b: DeviceBatch, classes: PodClasses | None,
                       tensors: Mapping[str, torch.Tensor] | None = None) -> DeviceBatch:
    """Keep ``classes`` with ``b`` (its device copies from ``tensors``, else
    uploaded now). The classes live on the batch object itself, so a
    ``dataclasses.replace`` of it, which may change a key leaf, carries
    none; ``with_nodes`` keeps them across a change of node rows only."""
    if classes is None or int(b.requests.shape[0]) != len(classes.class_of):
        return b
    if classes.shared:
        if tensors is None:
            tensors = upload_packed({"classes.reps": classes.host_reps(),
                                     "classes.rep_of": classes.host_rep_of(),
                                     "classes.class_idx": classes.class_of}, b.device)
        classes = dataclasses.replace(classes, reps=tensors["classes.reps"],
                                      rep_of=tensors["classes.rep_of"],
                                      class_idx=tensors["classes.class_idx"])
    object.__setattr__(b, "_pod_classes", classes)
    return b


def with_nodes(b: DeviceBatch, nodes: DeviceNodeState) -> DeviceBatch:
    """``b`` over other node rows (a placement hypothesis), its pod classes
    kept: no key leaf is a node row."""
    out = dataclasses.replace(b, nodes=nodes)
    classes = pod_classes(b)
    if classes is not None:
        object.__setattr__(out, "_pod_classes", classes)
    return out


def _align(n: int, a: int = 16) -> int:
    return (n + a - 1) // a * a


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=a.dtype)).dtype


def upload_packed(
    arrays: Mapping[str, np.ndarray], device
) -> dict[str, torch.Tensor]:
    """Ship numpy arrays to ``device`` in ONE host→device copy: they are
    packed into one 16-byte-aligned byte buffer, uploaded, and viewed back
    as typed tensors (each view is contiguous). The port's
    ``jax.device_put`` of a pytree."""
    arrays = {n: np.ascontiguousarray(np.asarray(a)) for n, a in arrays.items()}
    offsets = {}
    total = 0
    for name, a in arrays.items():
        offsets[name] = total
        total += _align(a.nbytes)
    buf = np.zeros(max(total, 16), dtype=np.uint8)
    for name, a in arrays.items():
        buf[offsets[name]:offsets[name] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev_buf = torch.from_numpy(buf).to(device)
    return {
        name: dev_buf[offsets[name]:offsets[name] + a.nbytes]
        .view(_torch_dtype(a)).view(a.shape)
        for name, a in arrays.items()
    }


def device_batch_from_numpy(
    leaves: Mapping[str, "np.ndarray | None"], device,
    resident: "ResidentNodeState | None" = None,
    delta: "Mapping[str, np.ndarray] | None" = None,
    classes: "PodClasses | None | str" = "auto",
) -> DeviceBatch:
    """Build a DeviceBatch from numpy leaves keyed by the reference's field
    names (the node block's six names plus every DeviceBatch leaf), in ONE
    host→device copy (``upload_packed``). This is the port's
    ``jax.device_put`` — and how a test carries ``jax.device_get`` of
    kubetpu's batch across. ``resident``, when given, is a node block
    already on the device: the node leaves are then not read, the pod
    leaves are shipped, and ``delta`` (``resident.refresh``'s dirty rows)
    rides the same copy and is scattered into the block right after it.

    The ``podaffinity`` and ``spread`` leaves are any objects with
    ``PodAffinityDevice``'s / ``SpreadDevice``'s attributes (kubetpu's, or
    the port encoders' ``PodAffinityTensors`` / ``SpreadTensors``); their
    arrays ride in the same buffer. So do the pod classes (``classes``,
    ``pod_classes_of(leaves)`` when "auto"), which the batch keeps."""
    if isinstance(classes, str):
        classes = pod_classes_of(leaves)
    arrays = dict(delta or {})
    if classes is not None and classes.shared:
        arrays["classes.reps"] = classes.host_reps()
        arrays["classes.rep_of"] = classes.host_rep_of()
        arrays["classes.class_idx"] = classes.class_of
    for name in (NODE_FIELDS if resident is None else ()) + POD_FIELDS:
        a = leaves.get(name)
        if a is None or name in NESTED:
            continue
        arrays[name] = a
    for name, (_, fields, _) in NESTED.items():
        obj = leaves.get(name)
        if obj is not None:
            for f in fields:
                arrays[name + "." + f] = getattr(obj, f)
    tensors = upload_packed(arrays, device)
    if resident is None:
        nodes = DeviceNodeState(**{n: tensors[n] for n in NODE_FIELDS})
    else:
        if delta is not None:
            resident.scatter(tensors)
        nodes = resident.device
    pods = {n: tensors.get(n) for n in POD_FIELDS}
    for name, (cls, fields, flags) in NESTED.items():
        obj = leaves.get(name)
        if obj is not None:
            pods[name] = cls(
                **{f: tensors[name + "." + f] for f in fields},
                **{f: (int if f in _COUNT_FIELDS else bool)(getattr(obj, f))
                   for f in flags},
            )
    return attach_pod_classes(DeviceBatch(nodes=nodes, **pods), classes, tensors)


def _node_block_nbytes(nodes: DeviceNodeState) -> int:
    return sum(int(getattr(nodes, n).nbytes) for n in NODE_FIELDS)


def batch_nbytes(b: DeviceBatch) -> int:
    """Bytes of every tensor leaf of the batch (the upload's payload
    without a resident node block)."""
    total = _node_block_nbytes(b.nodes)
    for n in POD_FIELDS:
        v = getattr(b, n)
        if isinstance(v, torch.Tensor):
            total += int(v.nbytes)
    for name, (_, fields, _) in NESTED.items():
        obj = getattr(b, name)
        if obj is not None:
            total += sum(int(getattr(obj, f).nbytes) for f in fields)
    return total


@dataclass
class EncodedBatch:
    """Host-side handle pairing the device batch with name lookups."""

    device: DeviceBatch
    node_names: list[str]
    pods: list[t.Pod]
    resource_names: list[str]
    num_nodes: int                  # real (unpadded) N
    num_pods: int                   # real (unpadded) P
    node_tensors: "enc.NodeTensors | None" = None
    # the batch's port-triple interning (shared with the preemption
    # victim encoder)
    port_vocab: object | None = None
    # host→device bytes this encode shipped: the pod leaves plus the node
    # block's share, ``node_upload_bytes`` (the whole block without a
    # resident block; the dirty-row delta, or 0, with one)
    upload_bytes: int = 0
    node_upload_bytes: int = 0
    # bytes of the device-resident node block backing this batch (0 when
    # the node block was a one-shot upload)
    resident_bytes: int = 0
    # wall seconds of the copies (and the resident block's scatter): the
    # last pageable copy waits for the device, so the span includes them
    upload_s: float = 0.0


class StaleStaticEncode(Exception):
    """A pre-encoded StaticBatch can no longer be finalized against the
    current cluster state (an assumed pod introduced a host-port triple
    outside the batch's interned vocabulary, or the nomination set
    changed). Callers fall back to a full re-encode."""


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device while a shard's kernels launch
    (a launch goes to a stream of the current device); no-op on the CPU."""
    import contextlib

    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def scatter_node_rows_plain(
    nodes: DeviceNodeState, idx: torch.Tensor, updates: Sequence[torch.Tensor]
) -> None:
    """The plain version of kernel B5 (``_scatter_node_rows``,
    kubetpu/framework/runtime.py:240): write ``updates`` (the six node
    fields' rows in ``NODE_FIELDS`` order, one row per entry of ``idx``)
    into rows ``idx`` of the six buffers of ``nodes``, in place. Entries of
    ``idx`` outside ``[0, N)`` are pads and are dropped (the reference's
    ``mode="drop"``); the others are distinct. ``index_copy_`` on the
    in-range entries."""
    N = nodes.alloc.shape[0]
    keep = torch.nonzero((idx >= 0) & (idx < N)).flatten()
    rows = idx[keep].long()
    for name, u in zip(NODE_FIELDS, updates):
        getattr(nodes, name).index_copy_(0, rows, u[keep])


class StalePlan(RuntimeError):
    """A resident block's scatter plan used after the block it was built
    for was replaced (a full upload)."""


class ScatterPlan:
    """Kernel B5's launch plan for one resident node block (one shard's
    under a mesh), built when the block's buffers are allocated (a full
    upload). For a block on the card it holds ``kernels.ScatterLaunch``:
    the six buffers, N and R validated once, so that a delta call checks
    only the shipped delta and launches once. ``scatter`` raises
    ``StalePlan``, writing nothing, once the owner has uploaded a new
    block; for a CPU block it runs ``scatter_node_rows_plain``."""

    def __init__(self, owner: "ResidentNodeState", nodes: DeviceNodeState) -> None:
        self.owner, self.nodes = owner, nodes
        self.epoch = owner.epoch
        self.launch = None
        if nodes.alloc.device.type == "cuda":
            from ..kernels import ScatterLaunch

            self.launch = ScatterLaunch(nodes)

    def scatter(self, tensors: Mapping[str, torch.Tensor]) -> None:
        """Write a shipped delta (``DELTA_FIELDS`` views on the block's
        device, packed by ``upload_packed``) into the block in place."""
        if self.epoch != self.owner.epoch:
            raise StalePlan(f"scatter plan of upload {self.epoch}: the block was replaced by "
                            f"upload {self.owner.epoch}")
        if self.launch is None:
            scatter_node_rows_plain(self.nodes, tensors[DELTA_FIELDS[0]],
                                    tuple(tensors[n] for n in DELTA_FIELDS[1:]))
        else:
            self.launch.scatter(tensors)


class _ShardBlock:
    """Shard g of a sharded resident block, as ``device_batch_from_numpy``
    reads a resident block: its rows and its scatter."""

    def __init__(self, owner: "ResidentNodeState", g: int) -> None:
        self.owner, self.g = owner, g

    @property
    def device(self) -> DeviceNodeState:
        return self.owner.shards[self.g]

    def scatter(self, tensors: Mapping[str, torch.Tensor]) -> None:
        self.owner.plans[self.g].scatter(tensors)


class ResidentNodeState:
    """Owner of the persistent device-resident node block: the reference's
    ``ResidentNodeState``.

    ``mesh`` (a ``parallel.mesh.NodeMesh``): the block then lives sharded,
    shard g's ``NC / G`` contiguous rows on ``mesh.devices[g]``
    (``shards``), as the reference's ``:311-341`` places them. On a pods x
    nodes grid the block is sharded over the node columns and the same on
    every pod row (the reference's ``node_state_shardings``): tile (i, j)
    holds its own copy of column j's rows on its device. A full upload
    places each shard's rows on its own device only, and a delta is ROUTED
    (kernel B5m, the reference's ``_make_routed_scatter``): the dirty rows
    are grouped by owning column on the host, each column's group padded
    to a common bucket with shard-local indices (pads index one past the
    shard's rows and are dropped), and each shard's block rides that
    shard's own copy and is scattered there by ``scatter_rows``, on every
    pod row of a grid. A shard no dirty row falls in receives nothing.
    ``last_upload_bytes_per_shard`` and ``last_rows_per_shard`` account
    each shard's (each tile's) share.

    ``refresh(nt, num_nodes)`` brings the device block up to date with the
    host ``NodeTensors``: a full upload when the block doesn't exist yet or
    is not comparable (resource axis / padded capacity change), a dirty-row
    delta consuming ``nt.pending_device_rows`` in steady state — host→
    device traffic O(Δ rows · R), not O(N · R) — and, when the encode was
    REBUILT but kept the same shape (node add/delete within a padding
    bucket), an *incremental reshard*: the old and new NodeTensors are
    diffed row-wise and only the rows that actually changed (plus the
    validity boundary) are shipped. A delta is returned as numpy arrays,
    not shipped: the caller packs them into the cycle's one host→device
    copy and hands their device views to ``scatter``.

    The reference donates the old buffers to its scatter; torch has no
    donation, so the scatter writes in place into the resident tensors and
    every DeviceNodeState handed out earlier shows the new values. The
    scheduler refreshes only after the previous cycle's device work has
    completed, and every launch is on one stream, so a scatter never
    overtakes a kernel that still reads the block.

    ``device``: where the block lives (the scheduler's device)."""

    def __init__(self, device="cuda", mesh=None) -> None:
        self.mesh = mesh
        self.where = torch.device(device) if mesh is None else mesh.devices[0]
        self.device: DeviceNodeState | None = None
        self.shards: list[DeviceNodeState] | None = None
        self._nt_token: object | None = None
        self._num_nodes = -1
        # full uploads so far, and the scatter plan of each shard's block
        # (one without a mesh), built by each
        self.epoch = 0
        self.plans: list[ScatterPlan] = []
        self.last_upload_bytes = 0
        size = 1 if mesh is None else mesh.size
        self.last_upload_bytes_per_shard: list[int] = [0] * size
        self.last_rows_per_shard: list[int] = [0] * size

    @property
    def nbytes(self) -> int:
        if self.shards is not None:
            return sum(_node_block_nbytes(b) for b in self.shards)
        return _node_block_nbytes(self.device) if self.device is not None else 0

    def block(self, g: int) -> _ShardBlock:
        """Shard g of the sharded block (``device_batch_from_numpy``'s
        ``resident``)."""
        return _ShardBlock(self, g)

    def _full_upload(self, nt: "enc.NodeTensors", num_nodes: int) -> None:
        NC = nt.alloc.shape[0]
        node_valid = np.zeros(NC, dtype=bool)
        node_valid[:num_nodes] = True
        rows = dict(
            alloc=nt.alloc,
            requested=nt.requested,
            nonzero_requested=nt.nonzero_requested,
            pod_count=nt.pod_count,
            allowed_pods=nt.allowed_pods,
            node_valid=node_valid,
        )
        if self.mesh is None:
            dev = DeviceNodeState(**upload_packed(rows, self.where))
            self.device = dev
            self.last_upload_bytes = _node_block_nbytes(dev)
            self.last_upload_bytes_per_shard = [self.last_upload_bytes]
            self.last_rows_per_shard = [NC]
        else:
            ng = self.mesh.node_shards
            if NC % ng:
                raise ValueError(f"{NC} padded nodes do not split into {ng} shards")
            per = NC // ng
            self.shards = [
                DeviceNodeState(**upload_packed(
                    {k: v[(t % ng) * per:(t % ng + 1) * per] for k, v in rows.items()}, d))
                for t, d in enumerate(self.mesh.devices)
            ]
            self.last_upload_bytes_per_shard = [_node_block_nbytes(b) for b in self.shards]
            self.last_upload_bytes = sum(self.last_upload_bytes_per_shard)
            self.last_rows_per_shard = [per] * self.mesh.size
        self.epoch += 1
        self.plans = [ScatterPlan(self, b) for b in (
            [self.device] if self.mesh is None else self.shards)]
        self._nt_token = nt
        self._num_nodes = num_nodes
        nt.pending_device_rows = set()   # start delta accumulation

    def _reshard_rows(
        self, nt: "enc.NodeTensors", num_nodes: int
    ) -> "list[int] | None":
        """Dirty rows for an incremental reshard: the encode was rebuilt
        (new NodeTensors object — node add/delete/reorder) but padded
        capacity and resource axis still match the resident block. Diff the
        old tensors (what the device holds, modulo their un-flushed pending
        rows) against the new ones and return the union of value-changed
        rows, the old pending set, and the validity boundary. None = not
        comparable (full upload)."""
        old = self._nt_token
        if old is None or getattr(old, "alloc", None) is None:
            return None
        diff = nt.diff_rows(old)
        if diff is None:
            return None
        rows = set(diff)
        if old.pending_device_rows:
            # rows dirty on the OLD tensors but never shipped: the device
            # copy differs from old AND possibly from new — re-send them
            rows.update(old.pending_device_rows)
        lo, hi = sorted((self._num_nodes, num_nodes))
        rows.update(range(lo, hi))   # validity flips on the boundary
        return sorted(rows)

    def _nothing_shipped(self) -> None:
        self.last_upload_bytes = 0
        self.last_upload_bytes_per_shard = [0] * len(self.last_upload_bytes_per_shard)
        self.last_rows_per_shard = [0] * len(self.last_rows_per_shard)

    def refresh(
        self, nt: "enc.NodeTensors", num_nodes: int
    ) -> "dict[str, np.ndarray] | list | None":
        """Bring the block up to date with ``nt``. Returns None when that
        is done (a full upload, or nothing to ship), else the dirty rows'
        delta (``DELTA_FIELDS``) that ``scatter`` must write once shipped;
        with a mesh, a list with each shard's routed delta (None for a
        shard with no dirty row), each for that shard's block."""
        pending = nt.pending_device_rows
        if (self.device is None and self.shards is None) or self._nt_token is None:
            self._full_upload(nt, num_nodes)
            return None
        if self._nt_token is not nt:
            # the encode was REBUILT (node add/delete/reorder): incremental
            # reshard when the block is still comparable, else full upload
            rows = self._reshard_rows(nt, num_nodes)
            if rows is None:
                self._full_upload(nt, num_nodes)
                return None
        elif pending is None:
            # same tensors object but no delta bookkeeping: be safe
            self._full_upload(nt, num_nodes)
            return None
        else:
            rows_set = set(pending)
            if self._num_nodes != num_nodes:
                # the append-incremental encode grew the node count IN
                # PLACE (same tensors object): the boundary rows flip
                # validity and ride the same delta scatter as any dirty
                # row — an add-wave must not force a full re-upload
                lo, hi = sorted((self._num_nodes, num_nodes))
                rows_set.update(range(lo, hi))
            if not rows_set:
                self._nothing_shipped()
                return None
            rows = sorted(rows_set)
        nt.pending_device_rows = set()
        self._nt_token = nt
        if not rows:
            # reshard diff found nothing to ship (values identical)
            self._nothing_shipped()
            self._num_nodes = num_nodes
            return None
        if 2 * len(rows) >= num_nodes:
            # dense update: a full contiguous upload beats a scatter
            self._full_upload(nt, num_nodes)
            return None
        self._num_nodes = num_nodes
        if self.mesh is not None:
            routed = self._routed(nt, rows, num_nodes)
            if routed is None:
                self._full_upload(nt, num_nodes)
            return routed
        delta = self._delta(nt, rows, num_nodes)
        self.last_upload_bytes_per_shard = [self.last_upload_bytes]
        self.last_rows_per_shard = [len(rows)]
        return delta

    def _routed(self, nt: "enc.NodeTensors", rows: list, num_nodes: int) -> "list | None":
        """Kernel B5m's host half: each shard's dirty rows as a
        ``DELTA_FIELDS`` block of shard-local indices, every block padded
        to one bucket (pads index the shard's row count and are dropped).
        None when the buckets would reach the full row count (the caller
        uploads whole: routing would not ship less). On a pods x nodes grid
        every tile of a column gets the column's block."""
        size = self.mesh.node_shards
        NC = nt.alloc.shape[0]
        per = NC // size
        rows_arr = np.asarray(rows, dtype=np.int64)
        shard_of = rows_arr // per
        counts = np.bincount(shard_of, minlength=size)
        bucket = enc.round_up(int(counts.max()), minimum=1)
        if size * bucket >= NC:
            return None
        out: list = []
        for g in range(size):
            mine = rows_arr[shard_of == g]
            if not len(mine):
                out.append(None)
                continue
            idx = np.full(bucket, per, dtype=np.int32)
            idx[: len(mine)] = mine - g * per

            def deltas(a: np.ndarray) -> np.ndarray:
                u = np.zeros((bucket,) + a.shape[1:], dtype=a.dtype)
                u[: len(mine)] = a[mine]
                return u

            u_vd = np.zeros(bucket, dtype=bool)
            u_vd[: len(mine)] = mine < num_nodes
            out.append(dict(zip(DELTA_FIELDS, (
                idx, deltas(nt.alloc), deltas(nt.requested),
                deltas(nt.nonzero_requested), deltas(nt.pod_count),
                deltas(nt.allowed_pods), u_vd,
            ))))
        out = [out[t % size] for t in range(self.mesh.size)]
        self.last_upload_bytes_per_shard = [
            0 if d is None else sum(int(a.nbytes) for a in d.values()) for d in out
        ]
        self.last_upload_bytes = sum(self.last_upload_bytes_per_shard)
        self.last_rows_per_shard = [int(counts[t % size]) for t in range(self.mesh.size)]
        return out

    def _delta(
        self, nt: "enc.NodeTensors", rows: list, num_nodes: int
    ) -> dict[str, np.ndarray]:
        """The dirty rows as ``DELTA_FIELDS`` arrays: the index row padded
        to a bucket with the padded node count (dropped by the scatter) and
        the six update arrays."""
        pad = enc.round_up(len(rows))
        idx = np.full(pad, nt.alloc.shape[0], dtype=np.int32)
        idx[: len(rows)] = rows

        def deltas(a: np.ndarray) -> np.ndarray:
            u = np.zeros((pad,) + a.shape[1:], dtype=a.dtype)
            u[: len(rows)] = a[rows]
            return u

        u_vd = np.zeros(pad, dtype=bool)
        u_vd[: len(rows)] = np.asarray(rows, dtype=np.int64) < num_nodes
        arrays = dict(zip(DELTA_FIELDS, (
            idx,
            deltas(nt.alloc),
            deltas(nt.requested),
            deltas(nt.nonzero_requested),
            deltas(nt.pod_count),
            deltas(nt.allowed_pods),
            u_vd,
        )))
        self.last_upload_bytes = sum(int(a.nbytes) for a in arrays.values())
        return arrays

    def scatter(self, tensors: Mapping[str, torch.Tensor]) -> None:
        """Write a shipped delta (``DELTA_FIELDS`` views on the block's
        device) into the block in place: kernel B5, through the block's
        plan."""
        self.plans[0].scatter(tensors)


class PackingSolverState:
    """Device-resident dual-variable block for the packing engine: the
    warm-start twin of :class:`ResidentNodeState`. Copy of the reference's
    ``PackingSolverState`` (``kubetpu/framework/runtime.py:589-660``).

    Holds one ``(NC,)`` float32 dual-price vector λ per padded node
    capacity (each bucket size keeps its own prices). ``duals(n)`` pops the
    current vector for the solver (zeros on first sight of a capacity, a
    cold start counted in ``resets``) and the caller must ``store(n, …)``
    the returned vector back: this class is the only holder. ``carries``
    counts warm handoffs. ``device``: where the vectors live (the
    scheduler's device).

    ``mesh`` (a ``parallel.mesh.NodeMesh``, a node mesh or a pods x nodes
    grid): λ is held as a ``parallel.mesh.ShardedTensor``, one piece a
    tile on that tile's device (on a grid each node column's piece
    repeats down the pod rows, and the solves keep the copies equal), so
    the solver's per-node penalty row stays with the tile's node rows
    (``bind_mesh``: the engine is built before the scheduler resolves its
    mesh). Duals stored under another layout are dropped. ``nbytes``
    counts every piece held, each pod row's copies included."""

    def __init__(self, mesh=None, device="cuda") -> None:
        self._lam: dict = {}
        self.resets = 0
        self.carries = 0
        self.where = torch.device(device)
        self.mesh = None
        self.bind_mesh(mesh)

    def bind_mesh(self, mesh) -> None:
        if mesh == "off":
            mesh = None
        if mesh is self.mesh:
            return
        if mesh is not None:
            from ..parallel.mesh import NodeMesh

            if not isinstance(mesh, NodeMesh):
                raise TypeError(f"a resolved mesh (parallel.mesh.NodeMesh), got {mesh!r}")
        self.mesh = mesh
        # duals placed under the old layout are stale
        self._lam.clear()

    def duals(self, n: int):
        lam = self._lam.pop(n, None)
        if lam is not None:
            self.carries += 1
            return lam
        self.resets += 1
        if self.mesh is None or n % self.mesh.node_shards:
            # a capacity the node columns do not divide is a group cycle's
            # unsharded batch (the reference's device_put fails there)
            return torch.zeros(n, dtype=torch.float32, device=self.where)
        from ..parallel.mesh import ShardedTensor

        per = n // self.mesh.node_shards
        return ShardedTensor([torch.zeros(per, dtype=torch.float32, device=d)
                              for d in self.mesh.devices], rows=self.mesh.pod_shards)

    def store(self, n: int, lam) -> None:
        self._lam[n] = lam

    def reset(self) -> None:
        """Drop every price vector (cold-start escape hatch)."""
        self._lam.clear()

    @property
    def nbytes(self) -> int:
        return sum(int(x.nbytes) for v in self._lam.values()
                   for x in getattr(v, "pieces", [v]))


def _resource_weights(
    resource_names: Sequence[str], spec: Sequence[tuple[str, int]]
) -> np.ndarray:
    w = np.zeros(len(resource_names), dtype=np.int64)
    idx = {r: i for i, r in enumerate(resource_names)}
    for name, weight in spec:
        j = idx.get(name)
        if j is not None:
            w[j] = weight
    return w


def _is_scalar(resource_names: Sequence[str]) -> np.ndarray:
    return np.array(
        [r not in enc.BASE_RESOURCES for r in resource_names], dtype=bool
    )


def _image_tensors(
    nt: enc.NodeTensors, pods: Sequence[t.Pod], pad_pods: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ImageLocality host encoding (imagelocality/image_locality.go:60
    sumImageScores + :118 scaledImageScore): per (pod, node) the sum over the
    pod's container images present on the node of
    ``size * numNodesWithImage // totalNumNodes``. Signature-compressed: one
    (N,) row per distinct image set, pods carry the row index. (Copied from
    the reference verbatim.)"""
    N = nt.num_nodes
    NC = nt.alloc.shape[0]
    P = len(pods)
    PP = max(pad_pods or P, P)
    total = max(N, 1)
    if not any(p.images for p in pods):
        # no image anywhere → the raw score is identically zero; skip the
        # three device leaves entirely (feasible_and_scores None-guards)
        return None, None, None
    counts = np.zeros(PP, dtype=np.int32)
    sig = np.zeros(PP, dtype=np.int32)
    node_images: list[dict[str, t.ImageState]] = [
        dict(info.node.images) for info in nt.infos
    ]
    ids: dict[tuple[str, ...], int] = {(): 0}
    rows: list[np.ndarray] = [np.zeros(N, dtype=np.int64)]
    for i, p in enumerate(pods):
        counts[i] = len(p.images)
        key = p.images
        sid = ids.get(key)
        if sid is None:
            v = np.zeros(N, dtype=np.int64)
            for n_i, imgs in enumerate(node_images):
                s = 0
                for name in key:
                    st = imgs.get(name)
                    if st is not None:
                        s += st.size_bytes * st.num_nodes // total
                v[n_i] = s
            sid = len(rows)
            ids[key] = sid
            rows.append(v)
        sig[i] = sid
    sums = np.zeros((len(rows), NC), dtype=np.int64)
    for s, v in enumerate(rows):
        sums[s, :N] = v
    return sums, sig, counts


@dataclass
class StaticBatch:
    """The assume-independent half of an encoded batch (pipeline stage 1).

    Everything here is a function of the node set's static facts (labels,
    taints, images, ports vocabulary) and the pending pods — NOT of which
    pods are assigned where. The pipelined scheduler builds this while the
    previous cycle's device work runs, then ``finalize_batch`` patches in
    the assume-dependent slice (node resource rows via the resident block's
    delta upload, spread counts, affinity sums, in-use ports) after that
    cycle's assumes land. (The reference's ``folded`` and ``want_img`` are
    not kept: nothing here reads them after stage 1.)"""

    pods: list
    profile: "C.Profile | None"
    nt: "enc.NodeTensors"
    pb: "enc.PodBatch"
    resource_names: list[str]
    num_nodes: int
    num_pods: int
    pad_nodes: int
    pad_pods: int
    want_na: bool
    want_tt: bool
    want_spread: bool
    want_interpod: bool
    dra_score_raw: "np.ndarray | None"
    dra_score_sig: "np.ndarray | None"
    img_sums: "np.ndarray | None"
    img_sig: "np.ndarray | None"
    img_counts: "np.ndarray | None"
    node_valid: np.ndarray
    pod_valid: np.ndarray
    # identity of the nomination entries stage 1 encoded against (their
    # port triples joined the vocabulary); finalize_batch checks it
    nominated_key: tuple = ()
    # True when the static encode itself already depends on assignment state
    # (folded singleton scalars, volumes, DRA) — a pre-encoded StaticBatch
    # with this set must not be reused across an assume boundary
    assume_coupled: bool = False
    # set by refresh_static when node rows moved since stage 1: the in-use
    # port rows baked into ``pb`` are then stale and finalize re-derives
    # them from the current NodeInfos (the one-shot encode path keeps
    # pb.node_ports as-is — nothing ran in between)
    ports_stale: bool = False
    # the EncodeCache (state.encode_cache) stage 1 encoded against; stage 2
    # reuses its persistent affinity/spread term caches and template groups
    cache: object | None = None
    # wall seconds of stage 1's node-tensor encode (encode_snapshot)
    nodes_s: float = 0.0
    # topology mode ("off"|"auto"|"on") — finalize_batch attaches the dense
    # coordinate block when the mode is active AND any node carries a
    # topology label; coordinates are read fresh from the NodeTensors memo
    # at stage 2 so a label change between stages is never baked stale
    topology: str = "off"


def encode_batch(
    snapshot: Snapshot,
    pods: Sequence[t.Pod],
    profile: C.Profile | None = None,
    pad: bool = True,
    resource_names: Sequence[str] | None = None,
    nominated: Sequence = (),
    prev_nt: "enc.NodeTensors | None" = None,
    resident: "ResidentNodeState | None" = None,
    cache=None,
    track_changes: bool = True,
    device="cuda",
    topology: str = "off",
    mesh=None,
) -> EncodedBatch:
    """Snapshot + pending pods → padded device batch on ``device``: stage 1
    (``encode_batch_static``) then stage 2 (``finalize_batch``). ``mesh``
    (a ``parallel.mesh.NodeMesh``; the resident block's when None): the
    padded node count is a multiple of the shard count and the batch is a
    ``parallel.mesh.ShardedBatch`` placed by the sharding rules.

    Padding buckets P and N (``encoder.round_up``): padded nodes have zero
    allocatable and ``allowed_pods``=0 (infeasible for every pod), padded
    pods are invalid. ``prev_nt``: the previous cycle's
    ``EncodedBatch.node_tensors`` — ``encode_snapshot`` then refreshes only
    the node rows whose generation moved. ``resident``: a
    ResidentNodeState — the node block is delta-uploaded into its
    device-resident buffers instead of shipped whole (its device is the
    batch's). ``cache``: an ``encode_cache.EncodeCache`` — static pod rows
    become gathers over template-keyed rows shared across pods and cycles
    (the host-side O(Δ) twin of ``prev_nt``/``resident``). ``nominated``:
    the nominator's entries (``queue.nominator.NominatedPod``), whose
    reservations the fit and port filters charge. ``topology``: ``"on"``,
    ``"off"`` or ``"auto"`` — an active mode on a cluster with a slice or
    rack label attaches the ``topology`` leaf (``TopologyDevice``)."""
    if mesh is None and resident is not None:
        mesh = resident.mesh
    sb = encode_batch_static(
        snapshot, pods, profile, pad=pad, resource_names=resource_names,
        nominated=nominated, prev_nt=prev_nt, cache=cache,
        track_changes=track_changes, topology=topology,
        pad_multiple=1 if mesh is None else mesh.node_shards,
    )
    return finalize_batch(
        sb, snapshot, nominated=nominated, resident=resident, device=device,
        mesh=mesh,
    )


def encode_batch_static(
    snapshot: Snapshot,
    pods: Sequence[t.Pod],
    profile: C.Profile | None = None,
    pad: bool = True,
    resource_names: Sequence[str] | None = None,
    nominated: Sequence = (),
    prev_nt: "enc.NodeTensors | None" = None,
    cache=None,
    track_changes: bool = True,
    topology: str = "off",
    pad_multiple: int = 1,
) -> StaticBatch:
    """Stage 1: the assume-independent host encode (see StaticBatch), all
    numpy, no device call. ``track_changes=False`` (serial loop) skips the
    pipeline-only staleness diff in the incremental snapshot encode.
    ``pad_multiple``: the padded node count is rounded up to a multiple of
    it (a mesh's shard count, ``encoder.shard_aligned``)."""
    N, P = snapshot.num_nodes(), len(pods)
    NP = enc.shard_aligned(enc.round_up(N), pad_multiple) if pad else N
    PP = enc.round_up(P) if pad else P
    folded: frozenset = frozenset()
    if resource_names is None:
        resource_names, folded = enc.batch_resource_axis(snapshot, pods)
    # DRA (state.dra): pre-analyze the batch's claims so dense pool columns
    # join the resource axis BEFORE the node tensors are built; pool ids are
    # interned on the cache's index, keeping the axis cycle-stable for the
    # incremental encode
    dra_state = None
    want_dra_plugin = profile is None or (
        profile.has_filter(C.DYNAMIC_RESOURCES)
    )
    if (
        want_dra_plugin
        and getattr(snapshot, "dra", None) is not None
        and any(p_.resource_claims for p_ in pods)
    ):
        from ..state.dra import DraState

        dra_state = DraState(snapshot)
        for p_ in pods:
            dra_state.analyze(p_)
        pool_names = dra_state.pool_resource_names()
        if pool_names:
            resource_names = list(resource_names) + pool_names
    t_nodes = time.perf_counter()
    nt = enc.encode_snapshot(
        snapshot, resource_names=resource_names, pods=pods, pad_nodes=NP,
        prev=prev_nt, track_changes=track_changes,
    )
    nodes_s = time.perf_counter() - t_nodes
    if dra_state is not None and dra_state.used_pools:
        dra_state.fill_node_columns(
            nt, len(nt.resource_names) - len(dra_state.used_pools)
        )
    enabled = (
        frozenset(profile.filters.names()) if profile is not None else None
    )
    enabled_sc = (
        frozenset(profile.scores.names()) if profile is not None else None
    )
    nominated_triples: list[tuple[int, str, str]] = []
    for e in nominated:
        nominated_triples.extend(getattr(e, "ports", ()))
    vol_state = None
    if any(v.pvc_name for p_ in pods for v in p_.volumes):
        # a pod referencing a PVC engages the volume plugins even when the
        # listers are empty (a MISSING claim is what rejects it)
        from ..state.volumes import VolumeState

        vol_state = VolumeState(snapshot)
    # a nomination whose own pod sits in THIS batch is excluded: the folded
    # resource is a batch singleton, so the nominee is its only requester —
    # charging would block the nominee from its own nominated node (the
    # dense path's self-exclusion is the per-pod gate, e.uid != p.uid)
    batch_uids = {p_.uid for p_ in pods}
    folded_nominated = (
        [
            (e.node_name, tuple(e.requests))
            for e in nominated
            if getattr(e, "node_name", "") and e.uid not in batch_uids
        ]
        if folded else ()
    )
    pb = enc.encode_pod_batch(
        nt, pods, enabled_filters=enabled, pad_pods=PP,
        enabled_scores=enabled_sc, extra_port_triples=nominated_triples,
        volume_state=vol_state,
        folded_resources=folded,
        folded_nominated=folded_nominated,
        dra_state=dra_state,
        cache=cache,
    )
    # DRA prioritized-list score rows (per distinct host-spec set)
    dra_score_raw = dra_score_sig = None
    want_dra_score = profile is None or profile.has_score(C.DYNAMIC_RESOURCES)
    if dra_state is not None and want_dra_score:
        NC = nt.alloc.shape[0]
        row_ids: dict[tuple, int] = {}
        rows: list[np.ndarray] = []
        sig_arr = np.zeros(PP, dtype=np.int32)
        any_score = False
        for i, p_ in enumerate(pods):
            d = dra_state.analyze(p_)
            specs = tuple(
                s for s in d.host_specs
                if dra_state.spec_score(s, nt) is not None
            )
            sid = row_ids.get(specs)
            if sid is None:
                v = np.zeros(N, dtype=np.int64)
                for s in specs:
                    v = v + dra_state.spec_score(s, nt)
                sid = len(rows)
                row_ids[specs] = sid
                rows.append(v)
            sig_arr[i] = sid
            if specs:
                any_score = True
        if any_score:
            dra_score_raw = np.zeros((len(rows), NC), dtype=np.int64)
            for s_i, v in enumerate(rows):
                dra_score_raw[s_i, :N] = v
            dra_score_sig = sig_arr
    want_na = profile is None or profile.has_score(C.NODE_AFFINITY)
    want_tt = profile is None or profile.has_score(C.TAINT_TOLERATION)
    want_img = profile is None or profile.has_score(C.IMAGE_LOCALITY)
    want_spread = profile is None or (
        profile.has_filter(C.POD_TOPOLOGY_SPREAD)
        or profile.has_score(C.POD_TOPOLOGY_SPREAD)
    )
    want_interpod = profile is None or (
        profile.has_filter(C.INTER_POD_AFFINITY)
        or profile.has_score(C.INTER_POD_AFFINITY)
    )
    img_sums, img_sig, img_counts = (
        _image_tensors(nt, pods, pad_pods=PP)
        if want_img else (None, None, None)
    )
    node_valid = np.zeros(nt.alloc.shape[0], dtype=bool)
    node_valid[:N] = True
    pod_valid = np.zeros(PP, dtype=bool)
    pod_valid[:P] = True
    return StaticBatch(
        pods=list(pods),
        profile=profile,
        nt=nt,
        pb=pb,
        resource_names=nt.resource_names,
        num_nodes=N,
        num_pods=P,
        pad_nodes=nt.alloc.shape[0],
        pad_pods=PP,
        want_na=want_na,
        want_tt=want_tt,
        want_spread=want_spread,
        want_interpod=want_interpod,
        dra_score_raw=dra_score_raw,
        dra_score_sig=dra_score_sig,
        img_sums=img_sums,
        img_sig=img_sig,
        img_counts=img_counts,
        node_valid=node_valid,
        pod_valid=pod_valid,
        nominated_key=tuple(id(e) for e in nominated),
        assume_coupled=bool(folded) or dra_state is not None
        or vol_state is not None,
        cache=cache,
        nodes_s=nodes_s,
        topology=topology,
    )


def refresh_static(sb: StaticBatch, snapshot: Snapshot) -> bool:
    """Re-encode the node resource rows of a pre-encoded StaticBatch on its
    own axis (stage-2 entry: fold in the assumes that landed since stage 1).
    Returns False when the node SET changed since stage 1 — the StaticBatch
    is then unusable (its num_nodes/node_valid/static_mask are pinned at
    the stage-1 node count) and the caller must re-encode from scratch.
    Object identity alone does not detect that: the append-incremental
    encoder extends the SAME NodeTensors in place on a pure node add, so
    the node count is checked explicitly."""
    nt = enc.encode_snapshot(
        snapshot, resource_names=sb.resource_names, pods=(),
        pad_nodes=sb.pad_nodes, prev=sb.nt,
    )
    if nt is not sb.nt or nt.num_nodes != sb.num_nodes:
        return False
    if nt.last_dirty_rows:
        # node accounting moved (the assumes this refresh folds in) — the
        # stage-1 port rows no longer reflect in-use triples
        sb.ports_stale = True
    return True


def _node_port_rows(
    nt: "enc.NodeTensors", vocab, NC: int, K: int
) -> np.ndarray:
    """(NC, K) in-use port-triple rows from the CURRENT NodeInfo state —
    the assume-dependent half of the NodePorts tensors. Raises
    StaleStaticEncode when a node holds a triple outside the batch's
    interned vocabulary (an assume introduced a new triple; the conflict
    matrix can't express it)."""
    rows = np.zeros((NC, K), dtype=bool)
    for i, info in enumerate(nt.infos):
        for tr in info.port_triples:
            tid = vocab.get(tr)
            if tid < 0:
                raise StaleStaticEncode(f"port triple {tr} not in batch vocab")
            rows[i, tid] = True
    return rows


def finalize_batch(
    sb: StaticBatch,
    snapshot: Snapshot,
    nominated: Sequence = (),
    resident: "ResidentNodeState | None" = None,
    device="cuda",
    mesh=None,
) -> EncodedBatch:
    """Stage 2 (under ``mesh``, the resident block's when None, the batch
    is a ``parallel.mesh.ShardedBatch``, on a pods x nodes grid one of
    tiles: each shard's (tile's) pod leaves, its
    rows of the node-axis leaves and its routed delta ride one copy to its
    device): patch the assume-dependent slice onto a StaticBatch and
    build the device batch — spread counts and affinity sums encoded from
    the CURRENT NodeInfo state (through the cache's template groups when
    stage 1 had a cache), in-use ports recomputed when node rows moved
    since stage 1, and the node block delta-uploaded into ``resident``
    when given (else shipped whole). The pod leaves, the affinity rows,
    the spread tensors and the node block's dirty-row delta travel in one
    host→device copy (``device_batch_from_numpy``), the nominations'
    leaves too; only a full upload of the resident block is a copy of its
    own. Raises StaleStaticEncode when the StaticBatch can't be patched
    (nomination set changed since stage 1, or an unknown port triple)."""
    if tuple(id(e) for e in nominated) != sb.nominated_key:
        raise StaleStaticEncode("nomination set changed since static encode")
    profile, pods, nt, pb = sb.profile, sb.pods, sb.nt, sb.pb
    N, PP, NC = sb.num_nodes, sb.pad_pods, sb.pad_nodes
    cache = sb.cache
    if cache is not None:
        # namespace labels feed affinity namespaceSelectors: a moved
        # generation clears the cache's persistent match verdicts
        cache.sync_namespaces(snapshot.namespaces_generation)
    # template groups of the existing pods, shared by the spread and
    # affinity encoders (one O(pods) pass, built only if either needs it)
    _groups_memo: list = []

    def groups_of():
        if not _groups_memo:
            from ..state.encode_cache import groups_for

            _groups_memo.append(groups_for(nt, cache))
        return _groups_memo[0]

    pa = None
    # affinity-free cluster fast path: the cache maintains a count of
    # assigned pods carrying any (anti)affinity, so a SchedulingBasic-shaped
    # steady state skips the template-group pass AND the affinity encoder
    # in O(pending) attribute checks
    want_pa = sb.want_interpod and not (
        snapshot.pods_with_affinity == 0
        and not any(enc_podaffinity.has_any_affinity(p) for p in pods)
    )
    if want_pa:
        pa = enc_podaffinity.encode_pod_affinity(
            nt, pods,
            hard_pod_affinity_weight=(
                profile.hard_pod_affinity_weight if profile is not None else 1
            ),
            pad_pods=PP,
            namespaces=snapshot.namespaces,
            cache=cache,
            groups=groups_of(),
        )
    sp = None
    if sb.want_spread:
        defaults = (
            profile.default_spread_constraints if profile is not None else ()
        )
        sp = enc_spread.encode_spread(
            nt, pods, pad_pods=PP,
            default_constraints=defaults,
            default_selector_of=(
                enc_spread.default_selector_from_services(snapshot)
                if defaults and snapshot.services else None
            ),
            cache=cache,
            # reuse the affinity encoder's group pass when it ran; spread
            # builds its own only past its cheap no-constraints early-out
            groups=_groups_memo[0] if _groups_memo else None,
        )

    # in-use ports: the stage-1 rows are reused verbatim unless node state
    # moved since (refresh_static flags it) — then they are re-derived from
    # the current NodeInfos (assumes occupy ports)
    K = pb.port_conflict.shape[0]
    node_ports = (
        _node_port_rows(nt, pb.port_vocab, NC, K)
        if sb.ports_stale else pb.node_ports
    )

    # Nominator reservations (queue/nominator.py): the gate row for pod p
    # enables nomination g iff g's priority >= p's and g is not p itself
    # (framework/runtime's RunFilterPluginsWithNominatedPods rule).
    nom_node = nom_req = nom_gate = nom_ports = nom_pod_idx = None
    if nominated:
        name_to_idx = {n: j for j, n in enumerate(nt.node_names)}
        uid_to_idx = {p_.uid: i for i, p_ in enumerate(pods)}
        G = len(nominated)
        nom_node = np.full(G, -1, dtype=np.int32)
        nom_req = np.zeros((G, len(nt.resource_names)), dtype=np.int64)
        nom_gate = np.zeros((PP, G), dtype=bool)
        nom_ports = np.zeros((G, K), dtype=bool)
        nom_pod_idx = np.full(G, -1, dtype=np.int32)
        ridx = {r: j for j, r in enumerate(nt.resource_names)}
        for g, e in enumerate(nominated):
            nom_node[g] = name_to_idx.get(e.node_name, -1)
            nom_pod_idx[g] = uid_to_idx.get(e.uid, -1)
            for k, val in e.requests:
                j = ridx.get(k)
                if j is not None:
                    nom_req[g, j] = val
            for tr in getattr(e, "ports", ()):
                tid = pb.port_vocab.get(tr)
                if tid >= 0:
                    nom_ports[g, tid] = True
            for i, p_ in enumerate(pods):
                nom_gate[i, g] = e.priority >= p_.priority and e.uid != p_.uid

    # topology coordinates: attached ONLY when the mode is active and some
    # node actually carries a slice/rack label ("auto" on an unlabeled
    # cluster leaves the leaf absent, so every kernel's inputs and outputs
    # are those of topology-off)
    topo = None
    if sb.topology != "off":
        from ..state.topology import topology_tensors

        tt = topology_tensors(nt)
        if tt.labeled:
            topo = tt

    if mesh is None and resident is not None:
        mesh = resident.mesh
    t_up = time.perf_counter()
    if resident is not None:
        if mesh is not resident.mesh:
            raise ValueError("finalize_batch: the mesh is not the resident block's")
        if mesh is None and torch.device(device) != resident.where:
            raise ValueError(
                f"finalize_batch: device {device} but the resident block "
                f"lives on {resident.where}"
            )
        delta = resident.refresh(nt, N)
        node_upload = resident.last_upload_bytes
        resident_bytes = resident.nbytes
    else:
        delta = None
        resident_bytes = 0
    has_na = sb.want_na and pb.node_affinity_raw is not None
    has_tt = sb.want_tt and pb.taint_prefer_raw is not None
    leaves = dict(
        alloc=nt.alloc,
        requested=nt.requested,
        nonzero_requested=nt.nonzero_requested,
        pod_count=nt.pod_count,
        allowed_pods=nt.allowed_pods,
        node_valid=sb.node_valid,
        requests=pb.requests,
        nonzero_requests=pb.nonzero_requests,
        pod_valid=sb.pod_valid,
        static_mask=pb.static_mask,
        static_sig=pb.static_sig if pb.static_mask is not None else None,
        node_affinity_raw=pb.node_affinity_raw if has_na else None,
        taint_prefer_raw=pb.taint_prefer_raw if has_tt else None,
        score_sig=(
            pb.score_sig
            if pb.score_sig is not None and (has_na or has_tt) else None
        ),
        image_sum_scores=sb.img_sums,
        image_sig=sb.img_sig,
        image_count=sb.img_counts,
        pod_ports=pb.pod_ports,
        node_ports=node_ports,
        port_conflict=pb.port_conflict,
        nominated_node=nom_node,
        nominated_req=nom_req,
        nominated_gate=nom_gate,
        nominated_ports=nom_ports,
        nominated_pod_idx=nom_pod_idx,
        pod_priority=pb.priority,
        podaffinity=pa,
        spread=sp,
        dra_score_raw=sb.dra_score_raw,
        dra_score_sig=(
            sb.dra_score_sig if sb.dra_score_raw is not None else None
        ),
        topology=topo,
    )
    if mesh is None:
        dev = device_batch_from_numpy(leaves, device, resident=resident, delta=delta)
        total_bytes = batch_nbytes(dev)
        node_bytes = _node_block_nbytes(dev.nodes)
    else:
        from ..parallel.mesh import ShardedBatch, split_leaves

        pg, ng = mesh.pod_shards, mesh.node_shards
        per = NC // ng
        prow = leaves["requests"].shape[0] // pg if pg > 1 else None
        classes = pod_classes_of(leaves)
        shards = []
        for t, card in enumerate(mesh.devices):
            i, j = divmod(t, ng)
            rows_p = None if prow is None else slice(i * prow, (i + 1) * prow)
            # the routed scatter launches on the tile's card
            with on_device(card):
                shards.append(device_batch_from_numpy(
                    split_leaves(leaves, slice(j * per, (j + 1) * per), rows_p), card,
                    resident=None if resident is None else resident.block(t),
                    delta=None if delta is None else delta[t],
                    classes=classes if classes is None or rows_p is None
                    else classes.rows(rows_p.start, rows_p.stop),
                ))
        shards = tuple(shards)
        nominated = (shards[0].nominated_node if nom_node is None
                     else torch.from_numpy(nom_node).to(mesh.devices[0]))
        offsets = tuple(j * per for j in range(ng))
        dev = ShardedBatch(shards, offsets, mesh, nominated_node=nominated,
                           pod_offsets=(0,) if prow is None
                           else tuple(i * prow for i in range(pg)))
        total_bytes = sum(batch_nbytes(x) for x in shards)
        node_bytes = sum(_node_block_nbytes(x.nodes) for x in shards)
    upload_s = time.perf_counter() - t_up
    if resident is None:
        node_upload = node_bytes
    return EncodedBatch(
        device=dev,
        node_names=nt.node_names,
        pods=list(pods),
        resource_names=nt.resource_names,
        num_nodes=N,
        num_pods=sb.num_pods,
        node_tensors=nt,
        port_vocab=pb.port_vocab,
        upload_bytes=total_bytes - node_bytes + node_upload,
        node_upload_bytes=node_upload,
        resident_bytes=resident_bytes,
        upload_s=upload_s,
    )


@dataclass(frozen=True)
class ScoreParams:
    """Static numeric config of the cycle (weights aligned to the batch's
    resource axis)."""

    fit_weights: tuple[int, ...]
    balanced_weights: tuple[int, ...]
    is_scalar: tuple[bool, ...]
    strategy: str
    shape_x: tuple[int, ...]
    shape_y: tuple[int, ...]          # pre-scaled ×10 (MaxNodeScore/MaxCustomPriorityScore)
    w_fit: int
    w_balanced: int
    w_node_affinity: int
    w_taint: int
    w_image: int
    w_spread: int
    w_interpod: int
    w_dra: int
    filter_fit: bool
    filter_ports: bool
    filter_spread: bool
    filter_interpod: bool


def score_params(profile: C.Profile, resource_names: Sequence[str]) -> ScoreParams:
    ss = profile.scoring_strategy
    shape = ss.shape or ((0, 0), (100, 10))
    return ScoreParams(
        fit_weights=tuple(_resource_weights(resource_names, ss.resources).tolist()),
        balanced_weights=tuple(
            _resource_weights(resource_names, profile.balanced_resources).tolist()
        ),
        is_scalar=tuple(_is_scalar(resource_names).tolist()),
        strategy=ss.type,
        shape_x=tuple(x for x, _ in shape),
        shape_y=tuple(y * 10 for _, y in shape),
        w_fit=profile.score_weight(C.NODE_RESOURCES_FIT),
        w_balanced=profile.score_weight(C.NODE_RESOURCES_BALANCED),
        w_node_affinity=profile.score_weight(C.NODE_AFFINITY),
        w_taint=profile.score_weight(C.TAINT_TOLERATION),
        w_image=profile.score_weight(C.IMAGE_LOCALITY),
        w_spread=profile.score_weight(C.POD_TOPOLOGY_SPREAD),
        w_interpod=profile.score_weight(C.INTER_POD_AFFINITY),
        w_dra=profile.score_weight(C.DYNAMIC_RESOURCES),
        filter_fit=profile.has_filter(C.NODE_RESOURCES_FIT),
        filter_ports=profile.has_filter(C.NODE_PORTS),
        filter_spread=profile.has_filter(C.POD_TOPOLOGY_SPREAD),
        filter_interpod=profile.has_filter(C.INTER_POD_AFFINITY),
    )


def score_params_from_dict(d: Mapping[str, object]) -> ScoreParams:
    """ScoreParams from a mapping keyed by the reference's field names (e.g.
    ``dataclasses.asdict`` of kubetpu's ScoreParams)."""
    kw = {}
    for f in dataclasses.fields(ScoreParams):
        v = d[f.name]
        kw[f.name] = tuple(v) if isinstance(v, (list, tuple)) else v
    return ScoreParams(**kw)


def batch_leaves(b: DeviceBatch) -> dict[str, "torch.Tensor | None"]:
    """Every leaf of ``b`` keyed by field name (node block flattened)."""
    out = {n: getattr(b.nodes, n) for n in NODE_FIELDS}
    out.update({n: getattr(b, n) for n in POD_FIELDS})
    return out


def masked_normalize(raw: torch.Tensor, mask: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """DefaultNormalizeScore over feasible nodes only (the reference's
    nodeScoreList contains only nodes that passed Filter)."""
    return run_local(masked_normalize_steps(raw, mask, reverse))


def masked_normalize_steps(raw: torch.Tensor, mask: torch.Tensor, reverse: bool = False):
    """``masked_normalize`` in steps form (``ops.reduce``): the masked row
    maximum is its reduction over nodes."""
    masked = torch.where(mask, raw, 0)
    mx = yield ("max", torch.amax(masked, dim=-1, keepdim=True))
    return S.default_normalize(masked, reverse=reverse, mx=mx)


def _rows(a: torch.Tensor, sig: torch.Tensor | None) -> torch.Tensor:
    """Gather the per-pod rows of a signature-compressed (S, N) leaf."""
    return a if sig is None else a[sig.long()]


def filter_components(
    b: DeviceBatch,
    p: ScoreParams,
    requested: torch.Tensor | None = None,
    pod_count: torch.Tensor | None = None,
    node_ports: torch.Tensor | None = None,
    spread_counts: torch.Tensor | None = None,
    pa_sums: torch.Tensor | None = None,
    nominated_active: torch.Tensor | None = None,
):
    """``filter_components_steps`` on one device."""
    return run_local(filter_components_steps(
        b, p, requested=requested, pod_count=pod_count, node_ports=node_ports,
        spread_counts=spread_counts, pa_sums=pa_sums,
        nominated_active=nominated_active,
    ))


def filter_components_steps(
    b: DeviceBatch,
    p: ScoreParams,
    requested: torch.Tensor | None = None,
    pod_count: torch.Tensor | None = None,
    node_ports: torch.Tensor | None = None,
    spread_counts: torch.Tensor | None = None,
    pa_sums: torch.Tensor | None = None,
    nominated_active: torch.Tensor | None = None,
):
    """In steps form (``ops.reduce``; the spread filter's domain sums are
    its one reduction over nodes). Per-plugin Filter masks, un-ANDed — the split preemption needs:
    failures of ``static`` / ``spread_ok`` / ``pa_ok`` are unresolvable for
    the victim search, while ``fit`` / ``ports_ok`` failures are the
    resolvable kind (preemption.go:180 NodesForStatusCode). Returns
    ``(static, fit, ports_ok, spread_ok, pa_ok, sp_counts, pa_state)``; a
    mask entry is None when the plugin is disabled or has no work;
    ``sp_counts`` / ``pa_state`` are the spread counts and affinity sums
    the verdicts read (None without the leaf). ``nominated_active`` (G,)
    bool masks the nominations still charged (None: all of them)."""
    req = b.requested if requested is None else requested
    pc = b.pod_count if pod_count is None else pod_count
    ports = b.node_ports if node_ports is None else node_ports

    static = b.node_valid[None, :] & b.pod_valid[:, None]
    if b.static_mask is not None:
        static = static & _rows(b.static_mask, b.static_sig)
    fit = None
    if p.filter_fit:
        if b.nominated_node is not None:
            gate = b.nominated_gate
            if nominated_active is not None:
                # a nomination stops charging once its own pod was assigned
                # earlier in this batch (assume deletes the nomination)
                gate = gate & nominated_active[None, :]
            fit = F.resource_fit_mask_nominated(
                b.requests, b.alloc, req, pc, b.allowed_pods,
                gate, b.nominated_node, b.nominated_req,
            )
        else:
            fit = F.resource_fit_mask(
                b.requests, b.alloc, req, pc, b.allowed_pods
            )
    ports_ok = None
    if p.filter_ports:
        # conflict[p, n] = any pod triple k conflicting with in-use triple l.
        # The reference contracts int32 counts and tests > 0; an OR over the
        # boolean products is the same predicate (CUDA has no integer
        # matmul).
        wants_conf = torch.any(
            b.pod_ports[:, :, None] & b.port_conflict[None, :, :], dim=1
        )                                                     # (P, K)
        conflict = torch.any(
            wants_conf[:, None, :] & ports[None, :, :], dim=-1
        )                                                     # (P, N)
        if b.nominated_ports is not None and b.nominated_node is not None:
            # nominated pods' host ports are reserved on their nominated
            # node for >=-priority-gated pods, like their resources
            # (RunFilterPluginsWithNominatedPods adds the whole pod). The
            # reference's int32 (P,G)·(G,N) contraction tested > 0: here an
            # f64 product of 0/1 values, exact, tested > 0
            gate = b.nominated_gate
            if nominated_active is not None:
                gate = gate & nominated_active[None, :]
            nom_conf = torch.any(
                wants_conf[:, None, :] & b.nominated_ports[None, :, :], dim=-1
            )                                                 # (P, G)
            n_nodes = ports.shape[0]
            at_node = (
                b.nominated_node[:, None]
                == torch.arange(n_nodes, dtype=b.nominated_node.dtype,
                                device=ports.device)[None, :]
            )                                                 # (G, N)
            conflict = conflict | (
                (gate & nom_conf).to(torch.float64)
                @ at_node.to(torch.float64) > 0
            )
        ports_ok = ~conflict
    sp = b.spread
    sp_counts = None
    spread_ok = None
    if sp is not None:
        sp_counts = sp.node_count if spread_counts is None else spread_counts
        if p.filter_spread and sp.has_hard:
            spread_ok = yield from SP.spread_filter_steps(
                sp, sp_counts, sp.sig_idx, sp.action, sp.max_skew,
                sp.min_domains, sp.self_match,
            )
    pa = b.podaffinity
    pa_state = None
    pa_ok = None
    if pa is not None:
        pa_state = pa.base_sums if pa_sums is None else pa_sums
        if p.filter_interpod and pa.has_filter_work:
            pa_ok = PA.affinity_filter_pod(
                pa, pa_state, pa.fa_rows, pa.fa_self, pa.ra_rows, pa.ea_rows
            )
    return static, fit, ports_ok, spread_ok, pa_ok, sp_counts, pa_state


def feasible_and_scores(
    b: DeviceBatch,
    p: ScoreParams,
    requested: torch.Tensor | None = None,
    nonzero_requested: torch.Tensor | None = None,
    pod_count: torch.Tensor | None = None,
    node_ports: torch.Tensor | None = None,
    spread_counts: torch.Tensor | None = None,
    pa_sums: torch.Tensor | None = None,
    nominated_active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``feasible_and_scores_steps`` on one device."""
    return run_local(feasible_and_scores_steps(
        b, p, requested=requested, nonzero_requested=nonzero_requested,
        pod_count=pod_count, node_ports=node_ports,
        spread_counts=spread_counts, pa_sums=pa_sums,
        nominated_active=nominated_active,
    ))


def feasible_and_scores_steps(
    b: DeviceBatch,
    p: ScoreParams,
    requested: torch.Tensor | None = None,
    nonzero_requested: torch.Tensor | None = None,
    pod_count: torch.Tensor | None = None,
    node_ports: torch.Tensor | None = None,
    spread_counts: torch.Tensor | None = None,
    pa_sums: torch.Tensor | None = None,
    nominated_active: torch.Tensor | None = None,
):
    """In steps form (``ops.reduce``): its reductions over nodes are the
    spread domain sums, the normalize maxima (node affinity, taint, DRA),
    the spread score's scored count, domain bitmaps and min / max, and the
    affinity score's min / max. The full Filter + Score composition for a batch against ONE snapshot
    state. Returns ``(mask (P,N) bool, total (P,N) int64)``.

    Optional ``requested``/``nonzero_requested``/``pod_count``/``node_ports``,
    ``spread_counts``, ``pa_sums`` and ``nominated_active`` override the
    batch's node usage, spread counts, affinity sums and live nominations —
    the engines thread their running state through here, so this one
    function is both the one-shot and the stepped semantics."""
    req = b.requested if requested is None else requested
    nz = b.nonzero_requested if nonzero_requested is None else nonzero_requested
    dev = b.device
    w_fit = torch.tensor(p.fit_weights, dtype=torch.int64, device=dev)
    w_bal = torch.tensor(p.balanced_weights, dtype=torch.int64, device=dev)
    scal = torch.tensor(p.is_scalar, dtype=torch.bool, device=dev)

    # --- Filter ----------------------------------------------------------
    static, fit, ports_ok, spread_ok, pa_ok, sp_counts, pa_state = (
        yield from filter_components_steps(
            b, p, requested=requested, pod_count=pod_count,
            node_ports=node_ports, spread_counts=spread_counts,
            pa_sums=pa_sums, nominated_active=nominated_active,
        )
    )
    mask = static
    for part in (fit, ports_ok, spread_ok, pa_ok):
        if part is not None:
            mask = mask & part
    if b.extender_mask is not None:
        # findNodesThatPassExtenders (schedule_one.go:886): extenders only
        # shrink the feasible set
        mask = mask & b.extender_mask

    # --- Score -----------------------------------------------------------
    total = torch.zeros(mask.shape, dtype=torch.int64, device=dev)
    if p.w_fit:
        if p.strategy == C.LEAST_ALLOCATED:
            raw = S.least_allocated_score(b.nonzero_requests, nz, b.alloc, w_fit, scal)
        elif p.strategy == C.MOST_ALLOCATED:
            raw = S.most_allocated_score(b.nonzero_requests, nz, b.alloc, w_fit, scal)
        else:
            raw = S.requested_to_capacity_ratio_score(
                b.nonzero_requests, nz, b.alloc, w_fit, scal,
                torch.tensor(p.shape_x, dtype=torch.int64, device=dev),
                torch.tensor(p.shape_y, dtype=torch.int64, device=dev),
            )
        total = total + p.w_fit * raw          # no NormalizeScore (already 0..100)
    if p.w_balanced:
        raw = S.balanced_allocation_score(b.requests, req, b.alloc, w_bal, scal)
        total = total + p.w_balanced * raw
    if p.w_node_affinity and b.node_affinity_raw is not None:
        na_raw = _rows(b.node_affinity_raw, b.score_sig)
        total = total + p.w_node_affinity * (
            yield from masked_normalize_steps(na_raw, mask))
    if p.w_taint and b.taint_prefer_raw is not None:
        tt_raw = _rows(b.taint_prefer_raw, b.score_sig)
        total = total + p.w_taint * (
            yield from masked_normalize_steps(tt_raw, mask, reverse=True))
    if p.w_image and b.image_sum_scores is not None:
        img = _rows(b.image_sum_scores, b.image_sig)
        total = total + p.w_image * S.image_locality_score(img, b.image_count)
    sp = b.spread
    if sp is not None and p.w_spread and sp.has_soft:
        spread_sc = yield from SP.spread_score_steps(
            sp, sp_counts, sp.sig_idx, sp.action, sp.max_skew, sp.ignored,
            mask,
        )
        total = total + p.w_spread * spread_sc
    pa = b.podaffinity
    if pa is not None and p.w_interpod and pa.has_score_work:
        pa_sc = yield from PA.affinity_score_steps(
            pa, pa_state, pa.score_rows, pa.score_vals, mask
        )
        total = total + p.w_interpod * pa_sc
    if p.w_dra and b.dra_score_raw is not None:
        # DynamicResources prioritized-list score + DefaultNormalizeScore
        # (dynamicresources.go:1059 Score, :1138 NormalizeScore)
        dra_raw = _rows(b.dra_score_raw, b.dra_score_sig)
        total = total + p.w_dra * (yield from masked_normalize_steps(dra_raw, mask))
    if b.extender_score is not None:
        # extender Prioritize, pre-scaled weight*MaxNodeScore/MaxExtenderPriority
        # (schedule_one.go:1015) — added after plugin normalization
        total = total + b.extender_score
    return mask, total


def filter_score_batch(b, params: ScoreParams):
    """One-shot batch Filter+Score (all pods vs. the same snapshot). On a
    CUDA batch this launches the hand-written ``filter_score`` kernel; on a
    CPU batch it runs ``feasible_and_scores``. A sharded batch
    (``parallel.mesh.ShardedBatch``) returns each node column's (P, N / NG)
    rows as ``ShardedTensor``s: each pod row's tiles reduce in lockstep
    (``parallel.mesh.run_sharded``) on CPU devices and through the sharded
    ``filter_score`` launches on CUDA ones, and a column's rows join in pod
    order."""
    if hasattr(b, "shards"):
        from ..parallel.mesh import ShardedTensor, run_sharded

        ng = b.columns
        rows = []
        for i in range(b.pod_rows):
            tiles, mesh = b.shards[i * ng:(i + 1) * ng], b.mesh.row(i)
            if b.device.type == "cpu":
                rows.append(run_sharded(
                    [feasible_and_scores_steps(s, params) for s in tiles], mesh))
            else:
                from ..kernels import sharded_filter_score

                rows.append(sharded_filter_score(tiles, mesh, params))

        def column(j, k):
            dev = rows[0][j][k].device
            return torch.cat([r[j][k].to(dev) for r in rows])

        return (ShardedTensor([column(j, 0) for j in range(ng)], axis=1),
                ShardedTensor([column(j, 1) for j in range(ng)], axis=1))
    if b.device.type == "cpu":
        return feasible_and_scores(b, params)
    from ..kernels import filter_score

    return filter_score(b, params)
