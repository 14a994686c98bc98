"""Framework runtime — compose filter/score kernels per profile.

Port of ``kubetpu/framework/runtime.py``, narrowed to the slices ported so
far: the default profile's cycle with inter-pod affinity and topology
spread, and no nominations, extenders, DRA, volumes or topology slices.
Host encode is the reference's numpy code; the device batch is a frozen
dataclass of torch tensors on the caller's device, uploaded in one
host→device copy.

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
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from ..api import types as t
from ..ops import filters as F
from ..ops import podaffinity as PA
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
# the leaves that hold their own dataclass of tensors: (class, tensor
# fields, static flags)
NESTED = {
    "podaffinity": (PodAffinityDevice, PA_FIELDS,
                    ("has_filter_work", "has_score_work")),
    "spread": (SpreadDevice, SP_FIELDS, ("has_hard", "has_soft")),
}


@dataclass(frozen=True)
class DeviceBatch:
    """Padded device-resident scheduling problem: P pods × N nodes × R
    resources. Padding rows/cols are masked out (``node_valid``/``pod_valid``
    False, ``static_mask`` False on pads) so kernels need no special cases.

    Same field names and ``None`` leaves as the reference's pytree. The
    ``topology`` leaf and the nomination, extender and DRA leaves belong to
    later slices and are always None here."""

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
    nominated_node: torch.Tensor | None = None
    nominated_req: torch.Tensor | None = None
    nominated_gate: torch.Tensor | None = None
    nominated_ports: torch.Tensor | None = None
    nominated_pod_idx: torch.Tensor | None = None
    spread: SpreadDevice | None = None
    podaffinity: PodAffinityDevice | None = None
    static_sig: torch.Tensor | None = None  # (P,) int32 row into static_mask
    score_sig: torch.Tensor | None = None   # (P,) int32 row into na/tt raws
    image_sig: torch.Tensor | None = None   # (P,) int32 row into image sums
    extender_mask: torch.Tensor | None = None
    extender_score: torch.Tensor | None = None
    dra_score_raw: torch.Tensor | None = None
    dra_score_sig: torch.Tensor | None = None
    pod_priority: torch.Tensor | None = None     # (P,) int32
    topology: object | None = None

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
POD_FIELDS = tuple(
    f.name for f in dataclasses.fields(DeviceBatch) if f.name != "nodes"
)
# leaves of later slices: a batch that carries any of them is out of scope
LATER_SLICE_LEAVES = {
    "nominated_node": "Queue A item 8 (preemption and nominations)",
    "nominated_req": "Queue A item 8 (preemption and nominations)",
    "nominated_gate": "Queue A item 8 (preemption and nominations)",
    "nominated_ports": "Queue A item 8 (preemption and nominations)",
    "nominated_pod_idx": "Queue A item 8 (preemption and nominations)",
    "extender_mask": "Queue A item 9 (extender bridge)",
    "extender_score": "Queue A item 9 (extender bridge)",
    "dra_score_raw": "Queue A (DynamicResources)",
    "dra_score_sig": "Queue A (DynamicResources)",
    "topology": "Queue A item 10 (topology, kernel B12)",
}


def check_slice_leaves(leaves: Mapping[str, object], where: str) -> None:
    """Raise NotImplementedError naming the ROADMAP item when a leaf of a
    later slice is present."""
    for name, item in LATER_SLICE_LEAVES.items():
        if leaves.get(name) is not None:
            raise NotImplementedError(
                f"{where}: leaf {name!r} belongs to ROADMAP {item}, "
                "not yet ported"
            )


def _align(n: int, a: int = 16) -> int:
    return (n + a - 1) // a * a


def device_batch_from_numpy(
    leaves: Mapping[str, "np.ndarray | None"], device
) -> DeviceBatch:
    """Build a DeviceBatch from numpy leaves keyed by the reference's field
    names (the node block's six names plus every DeviceBatch leaf), in ONE
    host→device copy: the leaves are packed into one 16-byte-aligned byte
    buffer, uploaded, and viewed back as typed tensors (each view is
    contiguous). This is the port's ``jax.device_put`` — and how a test
    carries ``jax.device_get`` of kubetpu's batch across.

    The ``podaffinity`` and ``spread`` leaves are any objects with
    ``PodAffinityDevice``'s / ``SpreadDevice``'s attributes (kubetpu's, or
    the port encoders' ``PodAffinityTensors`` / ``SpreadTensors``); their
    arrays ride in the same buffer."""
    check_slice_leaves(leaves, "device_batch_from_numpy")
    arrays = {}
    for name in NODE_FIELDS + POD_FIELDS:
        a = leaves.get(name)
        if a is None or name in LATER_SLICE_LEAVES or name in NESTED:
            continue
        arrays[name] = np.ascontiguousarray(np.asarray(a))
    for name, (_, fields, _) in NESTED.items():
        obj = leaves.get(name)
        if obj is not None:
            for f in fields:
                arrays[name + "." + f] = np.ascontiguousarray(
                    np.asarray(getattr(obj, f))
                )
    offsets = {}
    total = 0
    for name, a in arrays.items():
        offsets[name] = total
        total += _align(a.nbytes)
    buf = np.zeros(max(total, 16), dtype=np.uint8)
    for name, a in arrays.items():
        buf[offsets[name]:offsets[name] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev_buf = torch.from_numpy(buf).to(device)
    tensors = {}
    for name, a in arrays.items():
        off = offsets[name]
        raw = dev_buf[off:off + a.nbytes]
        dtype = torch.from_numpy(np.empty(0, dtype=a.dtype)).dtype
        tensors[name] = raw.view(dtype).view(a.shape)
    nodes = DeviceNodeState(**{n: tensors[n] for n in NODE_FIELDS})
    pods = {n: tensors.get(n) for n in POD_FIELDS}
    for name, (cls, fields, flags) in NESTED.items():
        obj = leaves.get(name)
        if obj is not None:
            pods[name] = cls(
                **{f: tensors[name + "." + f] for f in fields},
                **{f: bool(getattr(obj, f)) for f in flags},
            )
    return DeviceBatch(nodes=nodes, **pods)


def batch_nbytes(b: DeviceBatch) -> int:
    """Bytes of every tensor leaf of the batch (the upload's payload)."""
    total = sum(int(getattr(b.nodes, n).nbytes) for n in NODE_FIELDS)
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
    # host→device bytes this encode shipped (the whole batch: the port has
    # no device-resident node block yet)
    upload_bytes: int = 0


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
    """The host half of an encoded batch: the snapshot's node tensors, the
    pod batch, the image leaves, the inter-pod affinity rows and the spread
    tensors, all numpy. ``finalize_batch`` turns it into the device
    batch."""

    pods: list
    nt: "enc.NodeTensors"
    pb: "enc.PodBatch"
    num_nodes: int
    num_pods: int
    want_na: bool
    want_tt: bool
    img_sums: "np.ndarray | None"
    img_sig: "np.ndarray | None"
    img_counts: "np.ndarray | None"
    node_valid: np.ndarray
    pod_valid: np.ndarray
    pa: "enc_podaffinity.PodAffinityTensors | None" = None
    sp: "enc_spread.SpreadTensors | None" = None


def _check_slice_pods(
    snapshot: Snapshot, pods: Sequence[t.Pod], profile: "C.Profile | None"
) -> None:
    """Raise NotImplementedError for inputs whose encode would produce a
    leaf of a later slice (the reference would build DRA or volume state
    for them)."""
    for p in pods:
        if p.resource_claims:
            raise NotImplementedError(
                f"pod {p.namespace}/{p.name}: resource claims (DRA) are not "
                "yet ported (ROADMAP Queue A)"
            )
        if any(v.pvc_name for v in p.volumes):
            raise NotImplementedError(
                f"pod {p.namespace}/{p.name}: PVC volumes are not yet "
                "ported (ROADMAP Queue A)"
            )


def encode_batch(
    snapshot: Snapshot,
    pods: Sequence[t.Pod],
    profile: C.Profile | None = None,
    pad: bool = True,
    resource_names: Sequence[str] | None = None,
    prev_nt: "enc.NodeTensors | None" = None,
    track_changes: bool = True,
    device="cuda",
) -> EncodedBatch:
    """Snapshot + pending pods → padded device batch on ``device``.

    Padding buckets P and N (``encoder.round_up``): padded nodes have zero
    allocatable and ``allowed_pods``=0 (infeasible for every pod), padded
    pods are invalid. ``prev_nt``: the previous cycle's
    ``EncodedBatch.node_tensors`` — ``encode_snapshot`` then refreshes only
    the node rows whose generation moved."""
    sb = encode_batch_static(
        snapshot, pods, profile, pad=pad, resource_names=resource_names,
        prev_nt=prev_nt, track_changes=track_changes,
    )
    return finalize_batch(sb, device=device)


def encode_batch_static(
    snapshot: Snapshot,
    pods: Sequence[t.Pod],
    profile: C.Profile | None = None,
    pad: bool = True,
    resource_names: Sequence[str] | None = None,
    prev_nt: "enc.NodeTensors | None" = None,
    track_changes: bool = True,
) -> StaticBatch:
    """The host encode (the reference's stage 1, narrowed to the slice):
    node tensors, the pod batch, the image rows, the inter-pod affinity
    rows and the spread tensors, all numpy. ``prev_nt`` and ``track_changes`` as in
    ``encode_batch``. (The reference encodes affinity in its stage 2,
    ``finalize_batch``, because its pipeline pre-encodes stage 1 before the
    cluster state is final; the port's cycle is serial, so the whole host
    encode is here and ``finalize_batch`` only ships leaves.)"""
    _check_slice_pods(snapshot, pods, profile)
    N, P = snapshot.num_nodes(), len(pods)
    NP = enc.round_up(N) if pad else N
    PP = enc.round_up(P) if pad else P
    folded: frozenset = frozenset()
    if resource_names is None:
        resource_names, folded = enc.batch_resource_axis(snapshot, pods)
    nt = enc.encode_snapshot(
        snapshot, resource_names=resource_names, pods=pods, pad_nodes=NP,
        prev=prev_nt, track_changes=track_changes,
    )
    enabled = (
        frozenset(profile.filters.names()) if profile is not None else None
    )
    enabled_sc = (
        frozenset(profile.scores.names()) if profile is not None else None
    )
    pb = enc.encode_pod_batch(
        nt, pods, enabled_filters=enabled, pad_pods=PP,
        enabled_scores=enabled_sc,
        folded_resources=folded,
    )
    want_na = profile is None or profile.has_score(C.NODE_AFFINITY)
    want_tt = profile is None or profile.has_score(C.TAINT_TOLERATION)
    want_img = profile is None or profile.has_score(C.IMAGE_LOCALITY)
    img_sums, img_sig, img_counts = (
        _image_tensors(nt, pods, pad_pods=PP)
        if want_img else (None, None, None)
    )
    want_interpod = profile is None or (
        profile.has_filter(C.INTER_POD_AFFINITY)
        or profile.has_score(C.INTER_POD_AFFINITY)
    )
    # affinity-free cluster fast path: the cache counts assigned pods
    # carrying any (anti)affinity, so a SchedulingBasic-shaped cycle skips
    # the template-group pass and the affinity encoder in O(pending)
    # attribute checks
    want_pa = want_interpod and not (
        snapshot.pods_with_affinity == 0
        and not any(enc_podaffinity.has_any_affinity(p) for p in pods)
    )
    # template groups of the existing pods, shared by the affinity and
    # spread encoders (one pass over the assigned pods, built only if
    # either needs it)
    groups = None
    pa = None
    if want_pa:
        from ..state.encode_cache import collect_pod_groups

        groups = collect_pod_groups(nt)
        pa = enc_podaffinity.encode_pod_affinity(
            nt, pods,
            hard_pod_affinity_weight=(
                profile.hard_pod_affinity_weight if profile is not None else 1
            ),
            pad_pods=PP,
            namespaces=snapshot.namespaces,
            groups=groups,
        )
    want_spread = profile is None or (
        profile.has_filter(C.POD_TOPOLOGY_SPREAD)
        or profile.has_score(C.POD_TOPOLOGY_SPREAD)
    )
    sp = None
    if want_spread:
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
            # reuse the affinity encoder's group pass when it ran; spread
            # builds its own only past its cheap no-constraints early-out
            groups=groups,
        )
    node_valid = np.zeros(nt.alloc.shape[0], dtype=bool)
    node_valid[:N] = True
    pod_valid = np.zeros(PP, dtype=bool)
    pod_valid[:P] = True
    return StaticBatch(
        pods=list(pods),
        nt=nt,
        pb=pb,
        num_nodes=N,
        num_pods=P,
        want_na=want_na,
        want_tt=want_tt,
        img_sums=img_sums,
        img_sig=img_sig,
        img_counts=img_counts,
        node_valid=node_valid,
        pod_valid=pod_valid,
        pa=pa,
        sp=sp,
    )


def finalize_batch(sb: StaticBatch, device="cuda") -> EncodedBatch:
    """Build the device batch of a StaticBatch on ``device``: the numpy
    leaves the reference's ``finalize_batch`` hands to ``jax.device_put``
    (later slices' leaves absent), the affinity rows and spread tensors
    included, shipped in one copy (``device_batch_from_numpy``)."""
    nt, pb = sb.nt, sb.pb
    has_na = sb.want_na and pb.node_affinity_raw is not None
    has_tt = sb.want_tt and pb.taint_prefer_raw is not None
    dev = device_batch_from_numpy(dict(
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
        node_ports=pb.node_ports,
        port_conflict=pb.port_conflict,
        pod_priority=pb.priority,
        podaffinity=sb.pa,
        spread=sb.sp,
    ), device)
    return EncodedBatch(
        device=dev,
        node_names=nt.node_names,
        pods=list(sb.pods),
        resource_names=nt.resource_names,
        num_nodes=sb.num_nodes,
        num_pods=sb.num_pods,
        node_tensors=nt,
        upload_bytes=batch_nbytes(dev),
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
    masked = torch.where(mask, raw, 0)
    return S.default_normalize(masked, reverse=reverse)


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
):
    """Per-plugin Filter masks, un-ANDed. Returns ``(static, fit, ports_ok,
    spread_ok, pa_ok, sp_counts, pa_state)``; a mask entry is None when the
    plugin is disabled or has no work; ``sp_counts`` / ``pa_state`` are the
    spread counts and affinity sums the verdicts read (None without the
    leaf)."""
    check_slice_leaves(batch_leaves(b), "filter_components")
    req = b.requested if requested is None else requested
    pc = b.pod_count if pod_count is None else pod_count
    ports = b.node_ports if node_ports is None else node_ports

    static = b.node_valid[None, :] & b.pod_valid[:, None]
    if b.static_mask is not None:
        static = static & _rows(b.static_mask, b.static_sig)
    fit = None
    if p.filter_fit:
        fit = F.resource_fit_mask(b.requests, b.alloc, req, pc, b.allowed_pods)
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
        ports_ok = ~conflict
    sp = b.spread
    sp_counts = None
    spread_ok = None
    if sp is not None:
        sp_counts = sp.node_count if spread_counts is None else spread_counts
        if p.filter_spread and sp.has_hard:
            spread_ok = SP.spread_filter_pod(
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full Filter + Score composition for a batch against ONE snapshot
    state. Returns ``(mask (P,N) bool, total (P,N) int64)``.

    Optional ``requested``/``nonzero_requested``/``pod_count``/``node_ports``,
    ``spread_counts`` and ``pa_sums`` override the batch's node usage,
    spread counts and affinity sums — the engines thread their running
    state through here, so this one function is both the one-shot and the
    stepped semantics."""
    req = b.requested if requested is None else requested
    nz = b.nonzero_requested if nonzero_requested is None else nonzero_requested
    dev = b.device
    w_fit = torch.tensor(p.fit_weights, dtype=torch.int64, device=dev)
    w_bal = torch.tensor(p.balanced_weights, dtype=torch.int64, device=dev)
    scal = torch.tensor(p.is_scalar, dtype=torch.bool, device=dev)

    # --- Filter ----------------------------------------------------------
    static, fit, ports_ok, spread_ok, pa_ok, sp_counts, pa_state = (
        filter_components(
            b, p, requested=requested, pod_count=pod_count,
            node_ports=node_ports, spread_counts=spread_counts,
            pa_sums=pa_sums,
        )
    )
    mask = static
    for part in (fit, ports_ok, spread_ok, pa_ok):
        if part is not None:
            mask = mask & part

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
        total = total + p.w_node_affinity * masked_normalize(na_raw, mask)
    if p.w_taint and b.taint_prefer_raw is not None:
        tt_raw = _rows(b.taint_prefer_raw, b.score_sig)
        total = total + p.w_taint * masked_normalize(tt_raw, mask, reverse=True)
    if p.w_image and b.image_sum_scores is not None:
        img = _rows(b.image_sum_scores, b.image_sig)
        total = total + p.w_image * S.image_locality_score(img, b.image_count)
    sp = b.spread
    if sp is not None and p.w_spread and sp.has_soft:
        spread_sc = SP.spread_score_pod(
            sp, sp_counts, sp.sig_idx, sp.action, sp.max_skew, sp.ignored,
            mask,
        )
        total = total + p.w_spread * spread_sc
    pa = b.podaffinity
    if pa is not None and p.w_interpod and pa.has_score_work:
        pa_sc = PA.affinity_score_pod(
            pa, pa_state, pa.score_rows, pa.score_vals, mask
        )
        total = total + p.w_interpod * pa_sc
    return mask, total


def filter_score_batch(b: DeviceBatch, params: ScoreParams):
    """One-shot batch Filter+Score (all pods vs. the same snapshot). On a
    CUDA batch this launches the hand-written ``filter_score`` kernel; on a
    CPU batch it runs ``feasible_and_scores``."""
    if b.device.type == "cpu":
        return feasible_and_scores(b, params)
    from ..kernels import filter_score

    return filter_score(b, params)
