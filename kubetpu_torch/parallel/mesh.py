"""The device mesh: the node axis, and the pods x nodes grid.

Port of ``kubetpu/parallel/mesh.py``. The reference places a batch on a
``jax.sharding.Mesh`` and lets XLA insert the cross-shard collectives into
its unchanged engines. PyTorch has no such compiler, so here a sharded
batch is held as its pieces, each on its own device, and the engines
reduce across the pieces explicitly, at the points the reference's
collectives sit.

**The node axis.** A ``ShardedBatch`` on a node mesh is G per-shard
``DeviceBatch``es: shard g holds the contiguous node rows ``[offset_g,
offset_g + N / G)`` of every node-axis leaf, on its own device, and a copy
of every pod-axis and replicated leaf.

- the plain versions (a CPU mesh) run every shard's steps-form Filter +
  Score (``ops.reduce``) in lockstep through ``run_sharded``, which
  combines the shards' partials (normalize maxima, domain sums and
  bitmaps, scored counts) before any shard goes on, then pick each step's
  node by the key (score, -global index) over the shards' bests
  (``assign.greedy``), the batched round's and the packing round's tie
  statistics over the shards' partial counts and hashes
  (``assign.batched``, ``assign.packing``: the packing solve also
  combines its row maxima, slice occupancy, marginal utility and
  objective sums), and the dry run's node over the shards' best five-key
  tuples (``ops.preemption``);
- on CUDA devices the hand-written kernels exchange the same partials
  between the shards' blocks (``kernels``).

**The pods x nodes grid** (``make_mesh_2d``, the reference's ``"pods"``
axis): the ``ShardedBatch`` holds PG x NG tiles; tile (i, j) holds pod row
i's P / PG rows of every pod-axis leaf and node column j's N / NG rows of
every node-axis leaf (a (P, N) leaf is cut on both), so each device owns
one (pod block x node block) tile of the quadratic Filter + Score work.
Node-axis leaves repeat down the pod rows. A node mesh is the grid with
one pod row, and the greedy and batched engines run both through one
path. They reduce over the node columns inside a pod row, and across the
pod rows at the points where the reference's rounds read every pod: the
batched engine's tie-spread rank (the rows' hashes joined in pod order),
its admissions (one pod a node over every row's choosers, with each
pod's pod-major leaves gathered once a batch, ``ShardedBatch.gathered``),
the first rejection, and the state increments, which every pod row's copy
of a node column takes; the greedy scan reads step p's pod from its pod
row. The packing solve adds its own: its row maxima of |score| reduce
over a pod row's columns, its banded tie rank joins the rows' vectors as
the batched engine's does, its admissions read every row's choosers in
admission order, and its duals λ are held a piece a tile (a column's
copies equal down the rows).

A mesh is an ordered list of ``torch.device``s, which may repeat:
``["cpu"] * G`` (the CPU tests' mesh), ``[cuda:0] * G`` (G logical shards
on one card) or ``cuda:0 .. cuda:G-1`` (one shard a card, with peer access
between every pair). ``make_multislice_mesh`` keeps the reference's two
axis names and shards the node dimension over both, which on a 1-D node
axis is the same G-way split under its own shape label. The gang lane's
group cycles do not shard: under any mesh they encode and solve an
unsharded batch on the mesh's first device, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from functools import cached_property
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from ..framework import runtime as rt
from ..ops.reduce import combine

AXIS = "nodes"
POD_AXIS = "pods"


@dataclass(frozen=True)
class NodeMesh:
    """An ordered list of devices, each the home of one node shard, with
    the reference's axis names and shape (``shape`` multiplies out to the
    device count; every axis shards the node dimension)."""

    devices: tuple
    axis_names: tuple = (AXIS,)
    shape: tuple = ()

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        if not self.shape:
            object.__setattr__(self, "shape", (len(devs),))
        if int(np.prod(self.shape)) != len(devs) or len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not fit {len(devs)} devices")
        types = {d.type for d in devs}
        if len(types) != 1:
            raise ValueError(f"a mesh's devices share one type, got {sorted(types)}")
        if POD_AXIS in self.axis_names and self.axis_names[0] != POD_AXIS:
            raise ValueError(f"the {POD_AXIS!r} axis comes first, got {self.axis_names}")
        # each pod row's node-axis mesh (one row without a pod axis), made
        # once: the kernels key their exchange buffers by the mesh
        pg = self.shape[0] if self.axis_names[0] == POD_AXIS else 1
        ng = len(devs) // pg
        rows = (self,) if pg == 1 else tuple(
            NodeMesh(devs[i * ng:(i + 1) * ng]) for i in range(pg))
        object.__setattr__(self, "_rows", rows)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def pod_shards(self) -> int:
        """PG: the pod rows (1 without a ``"pods"`` axis)."""
        return len(self._rows)

    @property
    def node_shards(self) -> int:
        """NG: the node columns (every device on a mesh without a pod axis)."""
        return self.size // self.pod_shards

    def row(self, i: int) -> "NodeMesh":
        """Pod row i's node-axis mesh: its NG devices, in column order."""
        return self._rows[i]

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def cards(self) -> list[torch.device]:
        """The distinct devices, in mesh order."""
        return list(dict.fromkeys(self.devices))


def _devices(devices: Sequence | None) -> list:
    if devices is not None:
        return list(devices)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Sequence | None = None, axis: str = AXIS) -> NodeMesh:
    """A 1-D node-axis mesh over ``devices`` (all CUDA devices when None).
    A mesh of several CUDA cards must have peer access between every pair
    (checked here, and enabled by the kernel library at first launch)."""
    mesh = NodeMesh(tuple(_devices(devices)), (axis,))
    check_peers(mesh)
    return mesh


def make_multislice_mesh(
    devices: Sequence | None = None, slices: int = 2,
    axis_names: tuple[str, str] = ("dcn", AXIS),
) -> NodeMesh:
    """A (slices x per-slice) mesh whose BOTH axes shard the node dimension:
    the same contiguous G-way split as ``make_mesh`` over the devices in
    order, under the reference's two-axis shape label."""
    devs = _devices(devices)
    if len(devs) % slices:
        raise ValueError(f"{len(devs)} devices do not split into {axis_names[0]}={slices}")
    mesh = NodeMesh(tuple(devs), tuple(axis_names), (slices, len(devs) // slices))
    check_peers(mesh)
    return mesh


def make_mesh_2d(devices: Sequence | None = None, pods: int = 2,
                 axis_names: tuple[str, str] = (POD_AXIS, AXIS)) -> NodeMesh:
    """A (pods x nodes) grid (``kubetpu/parallel/mesh.py:66``): ``pods`` pod
    rows, the devices in row-major order (tile (i, j) is device
    ``i * NG + j``). The devices may repeat, down to one card a tile or
    every tile on one card."""
    devs = _devices(devices)
    if len(devs) % pods:
        raise ValueError(f"{len(devs)} devices do not split into {axis_names[0]}={pods}")
    mesh = NodeMesh(tuple(devs), tuple(axis_names), (pods, len(devs) // pods))
    check_peers(mesh)
    return mesh


def check_peers(mesh: NodeMesh) -> None:
    """Every pair of distinct CUDA cards of the mesh must reach each other's
    memory (the kernels' exchange reads peers' slots through peer pointers).
    Raises, naming the pair, where one cannot: the mesh never falls back to
    copies through the host."""
    cards = [d for d in mesh.cards() if d.type == "cuda"]
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a.index, b.index):
                raise RuntimeError(f"no peer access from {a} to {b}: a node mesh needs it")


def resolve_mesh(spec, device="cuda") -> "NodeMesh | None":
    """The user-facing mesh switch as a NodeMesh or None (the reference's
    ``resolve_mesh``): None / ``"off"`` / False mean no mesh; a NodeMesh is
    used as it is; ``"auto"`` gives a 1-D mesh over the largest power of
    two of ``device``'s type's device count, or None when there is one
    device; ``"on"`` / True is "auto" that raises ValueError on a single
    device (a mesh was asked for)."""
    if spec is None or spec is False or spec == "off":
        return None
    if isinstance(spec, NodeMesh):
        return spec
    if spec not in ("auto", "on", True):
        raise ValueError(f"unknown mesh spec {spec!r}")
    kind = torch.device(device).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    n = 1
    while n * 2 <= count:
        n *= 2
    if n < 2:
        if spec in ("on", True):
            raise ValueError(f"mesh requested but only {count} {kind} device(s) visible")
        return None
    return make_mesh([torch.device(kind, i) for i in range(n)])


def node_axes_of(mesh: NodeMesh) -> "tuple[str | tuple[str, ...], str | None]":
    """The (node axis, pod axis) of a mesh, as the reference's ``_axes_of``
    infers them: a ``"pods"`` axis is the pod axis and the other shards
    nodes; without one every axis shards nodes."""
    names = tuple(mesh.axis_names)
    if POD_AXIS in names:
        rest = tuple(n for n in names if n != POD_AXIS)
        return (rest if len(rest) > 1 else rest[0]), POD_AXIS
    return (names if len(names) > 1 else names[0]), None


def node_pad_multiple(mesh: NodeMesh) -> int:
    """The node shard count: the padded node capacity is a multiple of it."""
    return mesh.node_shards


def node_state_shardings(mesh: NodeMesh, n: int) -> list[tuple[torch.device, slice]]:
    """Where the resident node block's rows live: for each device of the
    mesh (each tile of a pods x nodes grid, whose pod rows hold the same
    rows), its contiguous rows of the ``n``-row block."""
    ng = mesh.node_shards
    per = n // ng
    return [(d, slice((t % ng) * per, (t % ng + 1) * per)) for t, d in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# the sharding rules (the reference's _NODE_MAJOR, _SIG_NODE_LAST, _POD_NODE,
# _POD_MAJOR, _NESTED): the node axis and the pod axis of each leaf, None =
# not cut on that axis
# ---------------------------------------------------------------------------

_NODE_MAJOR = frozenset({
    "alloc", "requested", "nonzero_requested", "pod_count", "allowed_pods",
    "node_valid", "node_ports",
})
_SIG_NODE_LAST = frozenset({
    "static_mask", "node_affinity_raw", "taint_prefer_raw",
    "image_sum_scores", "dra_score_raw",
})
_POD_NODE = frozenset({"extender_mask", "extender_score"})
_POD_MAJOR = frozenset({
    "requests", "nonzero_requests", "pod_valid", "static_sig", "score_sig",
    "image_sig", "image_count", "pod_ports", "nominated_gate",
    "dra_score_sig", "pod_priority",
})
_NESTED = {
    "spread": dict(node_last=("eligible", "node_domain", "node_count", "has_key"),
                   pod_node=("ignored",), node_major=(),
                   pod_major=("sig_idx", "action", "max_skew", "min_domains",
                              "self_match", "pod_match_sig")),
    "podaffinity": dict(node_last=("node_domain", "has_key"), pod_node=(),
                        node_major=(),
                        pod_major=("update", "fa_rows", "fa_self", "ra_rows", "ea_rows",
                                   "score_rows", "score_vals")),
    "topology": dict(node_last=(), pod_node=(), node_major=("slice_id", "rack_id"),
                     pod_major=()),
}


def node_axis(field: str, parent: str | None = None) -> "int | None":
    """The axis of leaf ``field`` (of nested leaf ``parent``) that holds
    nodes: 0 node-major, 1 node-last or pod x node, None replicated."""
    if parent is not None:
        rules = _NESTED[parent]
        if field in rules["node_major"]:
            return 0
        if field in rules["node_last"] or field in rules["pod_node"]:
            return 1
        return None
    if field in _NODE_MAJOR:
        return 0
    if field in _SIG_NODE_LAST or field in _POD_NODE:
        return 1
    return None


def pod_axis(field: str, parent: str | None = None) -> "int | None":
    """The axis of leaf ``field`` (of nested leaf ``parent``) that holds
    pods on a pods x nodes grid: 0 for pod-major and pod x node leaves,
    None for leaves every pod row holds whole."""
    if parent is not None:
        rules = _NESTED[parent]
        return 0 if field in rules["pod_major"] or field in rules["pod_node"] else None
    return 0 if field in _POD_MAJOR or field in _POD_NODE else None


def _cut(x, axis: "int | None", lo: int, hi: int):
    if x is None or axis is None:
        return x
    index = [slice(None)] * x.ndim
    index[axis] = slice(lo, hi)
    return x[tuple(index)]


def _local_nominated(x, lo: int, hi: int):
    """A shard's view of the (G,) nominated nodes: its local row, -1 for
    a node of another shard (each shard charges its own nodes only)."""
    if x is None:
        return None
    inside = (x >= lo) & (x < hi)
    if isinstance(x, np.ndarray):
        return np.where(inside, x - lo, -1).astype(np.int32)
    return torch.where(inside, x - lo, -1).to(torch.int32)


def _cut2(x, n_axis, p_axis, nodes: slice, pods: "slice | None"):
    """``x`` cut to ``nodes`` on its node axis and, when ``pods`` is given,
    to ``pods`` on its pod axis."""
    x = _cut(x, n_axis, nodes.start, nodes.stop)
    if pods is not None:
        x = _cut(x, p_axis, pods.start, pods.stop)
    return x


def split_leaves(leaves: dict, nodes: slice, pods: "slice | None" = None) -> dict:
    """One shard's numpy leaves (``device_batch_from_numpy``'s names): the
    node rows ``nodes`` of every node-axis leaf and, for a tile of a pods x
    nodes grid, the pod rows ``pods`` of every pod-axis leaf; nested leaves
    become namespaces with their rows cut."""
    out = {}
    for name, leaf in leaves.items():
        if leaf is None:
            out[name] = None
        elif name in rt.NESTED:
            _, fields, flags = rt.NESTED[name]
            out[name] = SimpleNamespace(
                **{f: _cut2(getattr(leaf, f), node_axis(f, name), pod_axis(f, name),
                            nodes, pods) for f in fields},
                **{f: getattr(leaf, f) for f in flags},
            )
        elif name == "nominated_node":
            out[name] = _local_nominated(leaf, nodes.start, nodes.stop)
        else:
            out[name] = _cut2(leaf, node_axis(name), pod_axis(name), nodes, pods)
    return out


@dataclass(frozen=True)
class ShardedBatch:
    """A DeviceBatch split over a mesh's tiles: ``shards[i * NG + j]`` holds
    pod row i's rows ``[pod_offsets[i], pod_offsets[i] + P / PG)`` of every
    pod-axis leaf and node column j's rows ``[offsets[j], offsets[j] + N /
    NG)`` of every node-axis leaf (a (P, N) leaf is cut on both), on
    ``mesh.devices[i * NG + j]``; its ``nominated_node`` in local rows, -1
    for other columns' nodes. A node mesh is one pod row (``pod_offsets``
    ``(0,)``): every shard holds every pod. ``nominated_node`` keeps the
    global rows, which the host reads; the other pod-axis and replicated
    leaves read through ``gathered``'s first shard."""

    shards: tuple
    offsets: tuple
    mesh: NodeMesh
    nominated_node: "torch.Tensor | None" = None
    pod_offsets: tuple = (0,)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def pod_rows(self) -> int:
        return len(self.pod_offsets)

    @property
    def columns(self) -> int:
        return len(self.offsets)

    @property
    def num_pods(self) -> int:
        return self.pod_offsets[-1] + int(self.shards[-1].requests.shape[0])

    def tile(self, i: int, j: int) -> rt.DeviceBatch:
        return self.shards[i * self.columns + j]

    def full_tile(self, t: int) -> rt.DeviceBatch:
        """Tile t with the pod-major leaves of every pod row joined in pod
        order (the reference's all-gather along ``"pods"``), on tile t's
        device: what the commit reads of every pod. Its (P, N) leaves (the
        extender terms, the spread's ignored rows) are left out: they stay
        cut on their tiles. On one pod row, the shard itself. A tile on the
        card of its column's pod row 0 tile shares that tile's, built once
        a batch (``gathered``): the node leaves are the column's alike."""
        if self.pod_rows == 1:
            return self.shards[t]
        j = t % self.columns
        if self.shards[t].device == self.shards[j].device:
            return self.gathered.shards[j]
        return self._joined(t)

    def _joined(self, t: int) -> rt.DeviceBatch:
        """``full_tile(t)`` built: every pod row's pod-major leaves of tile
        t's column joined on tile t's device."""
        base = self.shards[t]
        j = t % self.columns
        dev = base.device

        def cat(get):
            parts = [get(self.tile(i, j)) for i in range(self.pod_rows)]
            return torch.cat([x.to(dev) for x in parts]).contiguous()

        def gathered(f, parent=None) -> bool:
            return pod_axis(f, parent) == 0 and node_axis(f, parent) is None

        leaves = {}
        for f in rt.POD_FIELDS:
            v = getattr(base, f)
            if v is None or not (f in rt.NESTED or isinstance(v, torch.Tensor)):
                continue
            if f in rt.NESTED:
                _, fields, _ = rt.NESTED[f]
                leaves[f] = dataclasses.replace(v, **{
                    k: cat(lambda x, f=f, k=k: getattr(getattr(x, f), k))
                    if gathered(k, f) else None
                    for k in fields if pod_axis(k, f) == 0 and getattr(v, k) is not None})
            elif gathered(f):
                leaves[f] = cat(lambda x, f=f: getattr(x, f))
            elif pod_axis(f) == 0:
                leaves[f] = None
        return dataclasses.replace(base, **leaves)

    @cached_property
    def gathered(self) -> "ShardedBatch":
        """Pod row 0's tiles with every pod's leaves (``full_tile``): the
        node-sharded batch of all P pods, on row 0's devices. Built once a
        batch; on one pod row, the batch itself."""
        if self.pod_rows == 1:
            return self
        return ShardedBatch(tuple(self._joined(j) for j in range(self.columns)),
                            self.offsets, self.mesh.row(0),
                            nominated_node=self.nominated_node)

    def __getattr__(self, name: str):
        # pod-axis and replicated leaves read through the gathered row's
        # first shard; a node-axis leaf has no whole here
        # (ShardedTensor.of gathers one on purpose)
        if name.startswith("_") or name in ("shards", "offsets", "mesh", "nominated_node",
                                            "pod_offsets", "gathered"):
            raise AttributeError(name)
        if node_axis(name) is not None or name in rt.NODE_FIELDS:
            raise AttributeError(f"{name} is node-sharded: read it from .shards")
        return getattr(self.gathered.shards[0], name)

    def replace_pod_node(self, **leaves) -> "ShardedBatch":
        """Attach (P, N) leaves (the extender terms), cut on both axes."""
        pb = int(self.shards[0].requests.shape[0])
        shards = []
        for t, s in enumerate(self.shards):
            i, j = divmod(t, self.columns)
            po, no = self.pod_offsets[i], self.offsets[j]
            n = int(s.alloc.shape[0])
            shards.append(dataclasses.replace(s, **{
                k: None if v is None else v[po:po + pb, no:no + n].to(s.device).contiguous()
                for k, v in leaves.items()}))
        return dataclasses.replace(self, shards=tuple(shards))


class ShardedTensor:
    """A node-axis tensor held as its shards' pieces (``axis`` is the node
    axis). On a pods x nodes grid (``rows`` pod rows) the pieces are the
    tiles', in tile order: each node column's piece repeats down the rows.
    ``gather`` joins pod row 0's pieces on one device: results read back,
    never an input to an engine."""

    def __init__(self, pieces: Sequence[torch.Tensor], axis: int = 0, rows: int = 1) -> None:
        self.pieces = list(pieces)
        self.axis = axis
        self.rows = rows

    @classmethod
    def split(cls, x: torch.Tensor, sb: "ShardedBatch") -> "ShardedTensor":
        """A whole (N,) node vector cut into ``sb``'s tiles' pieces, each on
        its tile's device."""
        return cls([x[sb.offsets[t % sb.columns]:][:int(s.alloc.shape[0])].to(s.device)
                    .contiguous() for t, s in enumerate(sb.shards)], rows=sb.pod_rows)

    def row(self, i: int) -> "ShardedTensor":
        """Pod row i's pieces."""
        ng = len(self.pieces) // self.rows
        return ShardedTensor(self.pieces[i * ng:(i + 1) * ng], self.axis)

    def gather(self, device=None) -> torch.Tensor:
        pieces = self.row(0).pieces
        dev = pieces[0].device if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in pieces], dim=self.axis)

    def cpu(self) -> torch.Tensor:
        return self.gather("cpu")


def _piece(b: rt.DeviceBatch, dev, nodes: slice, pods: "slice | None") -> rt.DeviceBatch:
    """One shard's (or tile's) DeviceBatch of ``b`` on ``dev``: the node
    rows ``nodes`` and, for a tile, the pod rows ``pods``; nominated nodes
    in local rows."""

    def put(x, n_axis, p_axis):
        if x is None:
            return None
        return _cut2(x, n_axis, p_axis, nodes, pods).to(dev).contiguous()

    state = rt.DeviceNodeState(
        **{f: put(getattr(b.nodes, f), 0, None) for f in rt.NODE_FIELDS})
    leaves = {}
    for f in rt.POD_FIELDS:
        v = getattr(b, f)
        if f in rt.NESTED and v is not None:
            _, fields, _ = rt.NESTED[f]
            leaves[f] = dataclasses.replace(
                v, **{k: put(getattr(v, k), node_axis(k, f), pod_axis(k, f)) for k in fields})
        elif f == "nominated_node":
            leaves[f] = None if v is None else _local_nominated(
                v, nodes.start, nodes.stop).to(dev)
        else:
            leaves[f] = v if not isinstance(v, torch.Tensor) else put(
                v, node_axis(f), pod_axis(f))
    return rt.DeviceBatch(nodes=state, **leaves)


def shard_batch(b: rt.DeviceBatch, mesh: NodeMesh, guard: bool = False) -> ShardedBatch:
    """Split ``b`` by the rules into a ``ShardedBatch``: each tile's node
    rows of the node-axis leaves and, on a pods x nodes grid, its pod rows
    of the pod-axis leaves, on its device; replicated leaves copied to
    every device. The padded node count must divide the node columns and
    the padded pod count the pod rows; with ``guard`` a count that does not
    degrades that axis to one shard holding every row (the reference's
    replicated leaf)."""
    n = int(b.alloc.shape[0])
    p = int(b.requests.shape[0])
    pg, ng = mesh.pod_shards, mesh.node_shards
    if n % ng:
        if not guard:
            raise ValueError(f"{n} padded nodes do not split into {ng} shards")
        ng = 1
    if p % pg:
        if not guard:
            raise ValueError(f"{p} padded pods do not split into {pg} pod rows")
        pg = 1
    per, pb = n // ng, p // pg
    if pg > 1:
        devs = [mesh.devices[i * mesh.node_shards + j] for i in range(pg) for j in range(ng)]
        sub = mesh if ng == mesh.node_shards else NodeMesh(tuple(devs), mesh.axis_names,
                                                           (pg, 1))
    else:
        row = mesh.row(0)
        devs = list(row.devices[:ng])
        sub = row if ng == row.size else NodeMesh(row.devices[:1])
    classes = rt.pod_classes(b)
    shards = tuple(
        rt.attach_pod_classes(
            _piece(b, devs[i * ng + j], slice(j * per, (j + 1) * per),
                   slice(i * pb, (i + 1) * pb) if pg > 1 else None),
            classes if classes is None or pg == 1 else classes.rows(i * pb, (i + 1) * pb))
        for i in range(pg) for j in range(ng))
    return ShardedBatch(shards, tuple(j * per for j in range(ng)), sub,
                        nominated_node=b.nominated_node,
                        pod_offsets=tuple(i * pb for i in range(pg)))


def run_sharded(steps: list, mesh: NodeMesh) -> list:
    """Run one steps-form generator a shard (``ops.reduce``) in lockstep:
    at each reduction point, combine the G partials on the mesh's first
    device and send the whole back to every shard. Returns each shard's
    value."""
    sent: list = [None] * len(steps)
    first = True
    while True:
        requests, values = [], []
        for g, s in enumerate(steps):
            try:
                requests.append(next(s) if first else s.send(sent[g]))
            except StopIteration as stop:
                values.append(stop.value)
        first = False
        if values:
            if len(values) != len(steps):
                raise RuntimeError("the shards left the reduction sequence out of step")
            return values
        ops = {op for op, _ in requests}
        if len(ops) != 1:
            raise RuntimeError(f"the shards reduce differently at one point: {ops}")
        home = mesh.devices[0]
        whole = combine(ops.pop(), [x.to(home) for _, x in requests])
        sent = [whole.to(d) for d in mesh.devices[: len(steps)]]


def first_best(keys: Sequence[tuple]) -> int:
    """The winner of the shards' bests: ``keys`` holds each shard's (key
    tuple, global index of its first best node), index -1 for no
    candidate, in shard order. A later shard wins only with a strictly
    greater key, so a tie keeps the earlier shard's node, the lower global
    index: the reference's first-max rule across shard boundaries (the
    greedy pick's key is (score,), the dry run's pick_node's five keys).
    Returns the global index, -1 for none."""
    best_k, best_n = None, -1
    for k, n in keys:
        if n >= 0 and (best_n < 0 or k > best_k):
            best_k, best_n = k, n
    return best_n


def sharded_greedy(b: rt.DeviceBatch, params: rt.ScoreParams, mesh: NodeMesh):
    """Shard ``b`` (on a node mesh or a pods x nodes grid) and run the
    greedy engine over the pieces."""
    from ..assign.greedy import greedy_assign_device

    return greedy_assign_device(shard_batch(b, mesh), params)


def sharded_batched(b: rt.DeviceBatch, params: rt.ScoreParams, mesh: NodeMesh,
                    max_rounds: int = 0):
    """Shard ``b`` (on a node mesh or a pods x nodes grid) and run the
    batched engine's rounds over the pieces."""
    from ..assign.batched import batched_assign_device

    return batched_assign_device(shard_batch(b, mesh), params, max_rounds=max_rounds)


def sharded_packing(b: rt.DeviceBatch, params: rt.ScoreParams, mesh: NodeMesh,
                    weights=None, max_iters: int = 0):
    """Shard ``b`` (on a node mesh or a pods x nodes grid) and run one cold
    packing solve (``kubetpu/parallel/mesh.py:369``; ``pod_axis="pods"``
    on a grid): λ starts at zero, one piece a tile. Returns the solver's
    six-tuple ``(assignments, final_state, lam, objective, iters,
    nodes_used)``, the final state's node slots (pod row 0's) and λ (every
    tile's) as ``ShardedTensor``s. ``weights``: a ``PackingWeights`` (the
    defaults when None)."""
    from ..assign.packing import PackingWeights, packing_assign_device

    sb = shard_batch(b, mesh)
    lam = ShardedTensor([torch.zeros(int(s.alloc.shape[0]), dtype=torch.float32,
                                     device=s.device) for s in sb.shards], rows=sb.pod_rows)
    w = (weights or PackingWeights()).tensor(sb.device)
    return packing_assign_device(sb, params, lam, w, max_iters)


def pod_scan_collective_ok(mesh: NodeMesh) -> bool:
    """The reference's check that a running maximum across shards computes
    right. On a pods x nodes grid the scan runs across the pod rows, in
    order (the batched engine's tie-spread rank reads every row's pods in
    pod order); on a node mesh, which has no pod axis, over the node
    shards. Each piece's cummax on its device, then the running maximum
    carried from piece to piece. True when it equals the unsharded
    cummax."""
    devs = ([mesh.row(i).devices[0] for i in range(mesh.pod_shards)]
            if mesh.pod_shards > 1 else list(mesh.devices))
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 100, size=64 * len(devs)).astype(np.int64))
    ref = torch.cummax(x, dim=0).values
    per = x.shape[0] // len(devs)
    carry, got = None, []
    for g, dev in enumerate(devs):
        piece = torch.cummax(x[g * per:(g + 1) * per].to(dev), dim=0).values
        if carry is not None:
            piece = torch.maximum(piece, carry.to(dev))
        carry = piece[-1]
        got.append(piece.cpu())
    return bool(torch.equal(torch.cat(got), ref))


def shard_argmax_plain(pieces: Sequence[torch.Tensor]) -> int:
    """The plain version of kernel K4: the first argmax of a node-sharded
    int64 vector, each shard's first maximum reduced by (value, -index)."""
    keys, off = [], 0
    for x in pieces:
        j = int(torch.argmax(x))
        keys.append(((int(x[j]),), off + j))
        off += int(x.shape[0])
    return first_best(keys)


def measure_collective_wall(mesh: NodeMesh, n: int = 1 << 14, repeats: int = 3) -> float:
    """Best-of-``repeats`` wall seconds of one cross-shard argmax over a
    node-sharded int64 vector of ``n`` (the reference's probe of the
    collective its engines' decisions ride on): kernel K4 on a CUDA mesh,
    its plain version on a CPU mesh. On a pods x nodes grid the probe runs
    over pod row 0's node columns. The first call (the build) is not
    timed."""
    mesh = mesh.row(0)
    per = n // mesh.size
    pieces = [torch.arange(g * per, (g + 1) * per, dtype=torch.int64, device=d)
              for g, d in enumerate(mesh.devices)]
    if mesh.device_type == "cpu":
        def once():
            return shard_argmax_plain(pieces)
    else:
        from ..kernels import shard_argmax

        def once():
            return shard_argmax(pieces, mesh)
    if once() != per * mesh.size - 1:
        raise RuntimeError("the cross-shard argmax probe disagrees with its input")
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    return best
