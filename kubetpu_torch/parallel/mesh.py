"""The node-axis mesh: every node-axis tensor in G shards, one a device.

Port of ``kubetpu/parallel/mesh.py``'s 1-D node axis. The reference places
a batch on a ``jax.sharding.Mesh`` and lets XLA insert the cross-shard
collectives into its unchanged engines. PyTorch has no such compiler, so
here a sharded batch is G per-shard ``DeviceBatch``es (``ShardedBatch``):
shard g holds the contiguous node rows ``[offset_g, offset_g + N / G)`` of
every node-axis leaf, on its own device, and a copy of every pod-axis and
replicated leaf. The engines run on each shard's rows and reduce across
shards explicitly, at the points the reference's collectives sit:

- the plain versions (a CPU mesh) run every shard's steps-form Filter +
  Score (``ops.reduce``) in lockstep through ``run_sharded``, which
  combines the shards' partials (normalize maxima, domain sums and
  bitmaps, scored counts) before any shard goes on, then pick each step's
  node by the key (score, -global index) over the shards' bests
  (``assign.greedy``), the batched round's tie statistics over the shards'
  partial counts and hashes (``assign.batched``), and the dry run's node
  over the shards' best five-key tuples (``ops.preemption``);
- on CUDA devices the hand-written kernels exchange the same partials
  between the shards' blocks (``kernels`` K1-K4).

A mesh is an ordered list of ``torch.device``s, which may repeat:
``["cpu"] * G`` (the CPU tests' mesh), ``[cuda:0] * G`` (G logical shards
on one card) or ``cuda:0 .. cuda:G-1`` (one shard a card, with peer access
between every pair). ``make_multislice_mesh`` keeps the reference's two
axis names and shards the node dimension over both, which on a 1-D node
axis is the same G-way split under its own shape label. The 2-D pods x
nodes mesh, the packing engine and the gang lane under a mesh are ROADMAP
Queue A item 12's remaining parts and raise.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from ..framework import runtime as rt
from ..ops.reduce import combine

AXIS = "nodes"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is ROADMAP Queue A item 12's remaining part, not yet ported"
    )


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

    @property
    def size(self) -> int:
        return len(self.devices)

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
                 axis_names: tuple[str, str] = ("pods", AXIS)):
    """The pods x nodes mesh (``kubetpu/parallel/mesh.py:66``): not ported."""
    raise _not_ported("the 2-D pods x nodes mesh")


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


def node_axes_of(mesh: NodeMesh) -> "tuple[str | tuple[str, ...], None]":
    """The (node axis, pod axis) of a mesh: every axis shards nodes; no pod
    axis on a 1-D node mesh."""
    names = tuple(mesh.axis_names)
    return (names if len(names) > 1 else names[0]), None


def node_pad_multiple(mesh: NodeMesh) -> int:
    """The shard count: the padded node capacity is a multiple of it."""
    return mesh.size


def node_state_shardings(mesh: NodeMesh, n: int) -> list[tuple[torch.device, slice]]:
    """Where the resident node block's rows live: for each shard, its
    device and its contiguous rows of the ``n``-row block."""
    per = n // mesh.size
    return [(d, slice(g * per, (g + 1) * per)) for g, d in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# the sharding rules (the reference's _NODE_MAJOR, _SIG_NODE_LAST, _POD_NODE,
# _POD_MAJOR, _NESTED): the node axis of each leaf, None = replicated
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
_NESTED = {
    "spread": dict(node_last=("eligible", "node_domain", "node_count", "has_key"),
                   pod_node=("ignored",), node_major=()),
    "podaffinity": dict(node_last=("node_domain", "has_key"), pod_node=(),
                        node_major=()),
    "topology": dict(node_last=(), pod_node=(), node_major=("slice_id", "rack_id")),
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


def split_leaves(leaves: dict, g: int, size: int, n: int) -> dict:
    """Shard g's numpy leaves (``device_batch_from_numpy``'s names) of a
    batch with ``n`` padded nodes split ``size`` ways; nested leaves become
    namespaces with their rows cut."""
    per = n // size
    lo, hi = g * per, (g + 1) * per
    out = {}
    for name, leaf in leaves.items():
        if leaf is None:
            out[name] = None
        elif name in rt.NESTED:
            _, fields, flags = rt.NESTED[name]
            out[name] = SimpleNamespace(
                **{f: _cut(getattr(leaf, f), node_axis(f, name), lo, hi) for f in fields},
                **{f: getattr(leaf, f) for f in flags},
            )
        elif name == "nominated_node":
            out[name] = _local_nominated(leaf, lo, hi)
        else:
            out[name] = _cut(leaf, node_axis(name), lo, hi)
    return out


@dataclass(frozen=True)
class ShardedBatch:
    """A DeviceBatch split over a node mesh: ``shards[g]`` holds rows
    ``[offsets[g], offsets[g] + N / G)`` of every node-axis leaf on
    ``mesh.devices[g]`` (its ``nominated_node`` in local rows, -1 for
    other shards' nodes), and every replicated leaf. ``nominated_node``
    keeps the global rows, which the host reads; the other replicated
    leaves read through shard 0."""

    shards: tuple
    offsets: tuple
    mesh: NodeMesh
    nominated_node: "torch.Tensor | None" = None

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def __getattr__(self, name: str):
        # replicated leaves read through shard 0; a node-axis leaf has no
        # whole here (ShardedTensor.of gathers one on purpose)
        if name.startswith("_") or name in ("shards", "offsets", "mesh"):
            raise AttributeError(name)
        if node_axis(name) is not None or name in rt.NODE_FIELDS:
            raise AttributeError(f"{name} is node-sharded: read it from .shards")
        return getattr(self.shards[0], name)

    def replace_pod_node(self, **leaves) -> "ShardedBatch":
        """Attach (P, N) leaves (the extender terms), cut by node."""
        shards = tuple(
            dataclasses.replace(s, **{
                k: None if v is None else _cut(v, 1, o, o + int(s.alloc.shape[0]))
                .to(s.device).contiguous() for k, v in leaves.items()
            })
            for s, o in zip(self.shards, self.offsets)
        )
        return dataclasses.replace(self, shards=shards)


class ShardedTensor:
    """A node-axis tensor held as its shards' pieces (``axis`` is the node
    axis). ``gather`` joins them on one device: results read back, never
    an input to an engine."""

    def __init__(self, pieces: Sequence[torch.Tensor], axis: int = 0) -> None:
        self.pieces = list(pieces)
        self.axis = axis

    def gather(self, device=None) -> torch.Tensor:
        dev = self.pieces[0].device if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in self.pieces], dim=self.axis)

    def cpu(self) -> torch.Tensor:
        return self.gather("cpu")


def shard_batch(b: rt.DeviceBatch, mesh: NodeMesh, guard: bool = False) -> ShardedBatch:
    """Split ``b`` by the rules: node-axis leaves cut into the mesh's G
    contiguous row blocks, each on its shard's device; replicated leaves
    copied to every shard's device. The padded node count must divide G;
    with ``guard`` a count that does not degrades the batch to one shard
    holding every row (the reference's replicated leaf)."""
    n = int(b.alloc.shape[0])
    size = mesh.size
    if n % size:
        if not guard:
            raise ValueError(f"{n} padded nodes do not split into {size} shards")
        size = 1
    per = n // size
    shards = []
    for g in range(size):
        dev = mesh.devices[g]
        lo, hi = g * per, (g + 1) * per

        def put(x, axis):
            if x is None:
                return None
            return _cut(x, axis, lo, hi).to(dev).contiguous()

        nodes = rt.DeviceNodeState(
            **{f: put(getattr(b.nodes, f), 0) for f in rt.NODE_FIELDS})
        pods = {}
        for f in rt.POD_FIELDS:
            v = getattr(b, f)
            if f in rt.NESTED and v is not None:
                _, fields, _ = rt.NESTED[f]
                pods[f] = dataclasses.replace(
                    v, **{k: put(getattr(v, k), node_axis(k, f)) for k in fields})
            elif f == "nominated_node":
                pods[f] = None if v is None else _local_nominated(v, lo, hi).to(dev)
            else:
                pods[f] = v if not isinstance(v, torch.Tensor) else put(v, node_axis(f))
        shards.append(rt.DeviceBatch(nodes=nodes, **pods))
    sub = mesh if size == mesh.size else NodeMesh(mesh.devices[:1])
    return ShardedBatch(tuple(shards), tuple(g * per for g in range(size)), sub,
                        nominated_node=b.nominated_node)


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
    """Shard ``b`` and run the greedy engine over the shards."""
    from ..assign.greedy import greedy_assign_device

    return greedy_assign_device(shard_batch(b, mesh), params)


def sharded_batched(b: rt.DeviceBatch, params: rt.ScoreParams, mesh: NodeMesh,
                    max_rounds: int = 0):
    """Shard ``b`` and run the batched engine's rounds over the shards."""
    from ..assign.batched import batched_assign_device

    return batched_assign_device(shard_batch(b, mesh), params, max_rounds=max_rounds)


def sharded_packing(b, params, mesh, weights=None, max_iters: int = 0):
    """The packing engine under a mesh (``kubetpu/parallel/mesh.py:369``)."""
    raise _not_ported("the packing engine under a mesh")


def pod_scan_collective_ok(mesh: NodeMesh) -> bool:
    """The reference's check that a running maximum across shards computes
    right. The 1-D node mesh has no pod axis, so the scan runs over the
    node shards' pieces in shard order: each shard's cummax, then the
    running maximum carried from shard to shard. True when it equals the
    unsharded cummax."""
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 100, size=64 * mesh.size).astype(np.int64))
    ref = torch.cummax(x, dim=0).values
    per = x.shape[0] // mesh.size
    carry, got = None, []
    for g, dev in enumerate(mesh.devices):
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
    its plain version on a CPU mesh. The first call (the build) is not
    timed."""
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
    if once() != n - 1:
        raise RuntimeError("the cross-shard argmax probe disagrees with its input")
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    return best
