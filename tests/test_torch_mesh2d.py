"""The port's pods x nodes mesh equals kubetpu, bit for bit.

Counterparts of ``tests/test_mesh.py``'s 2-D tests on 2x2, 2x4 and 4x2
``cpu`` grids (``parallel.mesh.make_mesh_2d``): every leaf placed by
kubetpu's pod- and node-axis rules (checked tile by tile against kubetpu's
own shards on its virtual CPU devices), the batched engine at seeds 0 and
2 and the greedy engine with their seven-slot state, the batches without
quadratic work, a tie batch whose hash group spans two pod rows, the
equality of every pod row's copy of the node rows, and
``Scheduler(mesh=make_mesh_2d(...))`` on both engines, pod for pod. The
port is held to kubetpu's UNSHARDED engines, which its 2-D engines equal
by design, so no test depends on kubetpu's ``pod_scan_collective_ok``
probe. The packing engine on the grid is held in
``test_torch_packing_grid.py``, the gang lane under a mesh in
``test_torch_gang_mesh.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax

from kubetpu.assign.batched import batched_assign_device as k_batched
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.parallel import make_mesh_2d as k_make_mesh_2d
from kubetpu.parallel import shard_batch as k_shard_batch
from kubetpu.perf import workloads as KW

from kubetpu_torch.assign.batched import batched_assign_plain, batched_assign_tiled_plain
from kubetpu_torch.assign.greedy import greedy_assign_tiled_plain
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.parallel import mesh as M
from kubetpu_torch.perf import workloads as PW
from kubetpu_torch.sched import Scheduler as PScheduler

from .test_mesh import _build
from .test_sharded import _run_cluster as k_run_cluster
from .test_torch_mesh import _assert_result, _minimal, _tie_batch
from .test_torch_sharded import _port_run
from .torch_port_util import port_batch_from_jax, port_params

SHAPES = [(2, 2), (2, 4), (4, 2)]
IDS = ["2x2", "2x4", "4x2"]


def grid(pg, ng):
    return M.make_mesh_2d(["cpu"] * (pg * ng), pods=pg)


def test_grid_axes_and_rows():
    g = grid(2, 4)
    assert g.shape == (2, 4) and g.axis_names == ("pods", "nodes")
    assert (g.pod_shards, g.node_shards) == (2, 4)
    assert M.node_axes_of(g) == ("nodes", "pods")
    assert M.node_pad_multiple(g) == 4
    assert g.row(1).size == 4 and g.row(1).axis_names == ("nodes",)
    assert g.row(0) is g.row(0)
    placed = M.node_state_shardings(g, 16)
    assert [s for _, s in placed] == [slice(0, 4), slice(4, 8), slice(8, 12),
                                      slice(12, 16)] * 2
    with pytest.raises(ValueError, match="do not split"):
        M.make_mesh_2d(["cpu"] * 6, pods=4)
    assert M.pod_scan_collective_ok(g)
    assert M.measure_collective_wall(g, n=1 << 10) >= 0.0


# leaves checked tile by tile against kubetpu's shards: (path, the pod-axis
# rule, the node-axis rule), each the axis cut or None
_LEAVES = [
    (("requests",), 0, None), (("pod_valid",), 0, None), (("static_sig",), 0, None),
    (("alloc",), None, 0), (("requested",), None, 0), (("node_valid",), None, 0),
    (("static_mask",), None, 1), (("pod_ports",), 0, None),
    (("podaffinity", "update"), 0, None), (("podaffinity", "node_domain"), None, 1),
    (("podaffinity", "base_sums"), None, None),
    (("spread", "ignored"), 0, 1), (("spread", "eligible"), None, 1),
    (("spread", "sig_idx"), 0, None), (("spread", "node_count"), None, 1),
]


def _get(b, path):
    for name in path:
        b = getattr(b, name)
    return b


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_placement_on_both_axes(shape):
    """Tile (i, j) holds pod row i's rows of every pod-axis leaf and node
    column j's rows of every node-axis leaf; a (P, N) leaf is cut on both;
    node-axis leaves repeat down the pod rows. Each tile equals kubetpu's
    shard on device (i, j) of its own grid of the same shape."""
    pg, ng = shape
    batch, _ = _build(seed=7)
    kb = batch.device
    tb = M.shard_batch(port_batch_from_jax(kb), grid(pg, ng))
    assert isinstance(tb, M.ShardedBatch) and (tb.pod_rows, tb.columns) == (pg, ng)
    p, n = kb.requests.shape[0], kb.alloc.shape[0]
    assert tb.pod_offsets == tuple(range(0, p, p // pg))
    assert tb.offsets == tuple(range(0, n, n // ng))
    kmesh = k_make_mesh_2d(jax.devices()[:pg * ng], pods=pg)
    ksb = k_shard_batch(kb, kmesh, axis="nodes", pod_axis="pods")
    for path, pax, nax in _LEAVES:
        leaf = _get(ksb, path)
        shards = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        for i in range(pg):
            for j in range(ng):
                mine = _get(tb.tile(i, j), path).numpy()
                assert np.array_equal(mine, shards[kmesh.devices[i, j]]), (path, i, j)
                want = np.asarray(_get(kb, path))
                if pax is not None:
                    want = np.take(want, range(i * (p // pg), (i + 1) * (p // pg)), axis=pax)
                if nax is not None:
                    want = np.take(want, range(j * (n // ng), (j + 1) * (n // ng)), axis=nax)
                assert np.array_equal(mine, want), (path, i, j)
    # pod and replicated leaves read whole through the gathered row
    assert torch.equal(tb.requests, port_batch_from_jax(kb).requests)
    assert tb.num_pods == p
    full = tb.gathered
    assert len(full.shards) == ng and full.shards[0].requests.shape[0] == p
    # the gathered row joins the pod-major leaves only: a (P, N) leaf
    # stays cut on its tiles
    assert full.shards[0].spread.sig_idx.shape[0] == p
    assert full.shards[0].spread.ignored is None


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_one_shot_filter_score_on_a_grid(shape):
    """filter_score_batch (the extender Prioritize path) on the grid: each
    pod row's tiles reduce over their node columns, and each column's rows
    join in pod order into kubetpu's unsharded mask and total."""
    from kubetpu.framework import runtime as krt

    batch, params = _build(seed=5)
    ref_mask, ref_total = krt.filter_score_batch(batch.device, params)
    tb = M.shard_batch(port_batch_from_jax(batch.device), grid(*shape))
    mask, total = prt.filter_score_batch(tb, port_params(params))
    assert np.array_equal(mask.cpu().numpy(), np.asarray(ref_mask))
    assert np.array_equal(total.cpu().numpy(), np.asarray(ref_total))


def test_guard_degrades_the_pod_axis():
    batch, _ = _build(seed=7)
    b = port_batch_from_jax(batch.device)
    g = grid(3, 2)   # 32 padded pods do not split into 3 pod rows
    with pytest.raises(ValueError, match="pod rows"):
        M.shard_batch(b, g)
    sb = M.shard_batch(b, g, guard=True)
    assert isinstance(sb, M.ShardedBatch) and len(sb.shards) == 2
    assert torch.equal(sb.requests, b.requests)


def test_nominated_nodes_are_local_to_the_column():
    b = port_batch_from_jax(_build(seed=7)[0].device)
    n = b.alloc.shape[0]
    nom = torch.tensor([0, n // 2, n - 1, -1], dtype=torch.int32)
    b = dataclasses.replace(b, nominated_node=nom)
    tb = M.shard_batch(b, grid(2, 2))
    for i in range(2):
        assert tb.tile(i, 0).nominated_node.tolist() == [0, -1, -1, -1]
        assert tb.tile(i, 1).nominated_node.tolist() == [-1, 0, n // 2 - 1, -1]
    assert torch.equal(tb.nominated_node, nom)


def _rows_equal(rows):
    for row in rows[1:]:
        for x, y in zip(row, rows[0]):
            if x is None:
                assert y is None
                continue
            assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("seed", [0, 2])
def test_batched_exact_parity(seed, shape):
    """The batched engine on the grid equals kubetpu's unsharded engine:
    assignments and the seven-slot state; every pod row's copy of the node
    rows ends equal."""
    batch, params = _build(seed=seed)
    want = k_batched(batch.device, params)
    tb = M.shard_batch(port_batch_from_jax(batch.device), grid(*shape))
    rows = []
    _assert_result(want, batched_assign_tiled_plain(tb, port_params(params), rows_out=rows))
    assert len(rows) == shape[0]
    _rows_equal(rows)
    _assert_result(want, M.sharded_batched(port_batch_from_jax(batch.device),
                                           port_params(params), grid(*shape)))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("seed", [1, 2])
def test_greedy_exact_parity(seed, shape):
    batch, params = _build(seed=seed)
    want = k_greedy(batch.device, params)
    tb = M.shard_batch(port_batch_from_jax(batch.device), grid(*shape))
    rows = []
    _assert_result(want, greedy_assign_tiled_plain(tb, port_params(params), rows_out=rows))
    _rows_equal(rows)
    _assert_result(want, M.sharded_greedy(port_batch_from_jax(batch.device),
                                          port_params(params), grid(*shape)))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_no_quadratic_work(engine, shape):
    """The grid holds when the spread and affinity leaves are None."""
    batch, params = _minimal(11 if engine == "greedy" else 13, 24, 12)
    kfn = k_greedy if engine == "greedy" else k_batched
    pfn = M.sharded_greedy if engine == "greedy" else M.sharded_batched
    _assert_result(kfn(batch.device, params),
                   pfn(port_batch_from_jax(batch.device), port_params(params), grid(*shape)))


def _group_batch(n_nodes=16, n_pods=12):
    """Identical empty nodes and identical pods: one tie-spread hash group."""
    from kubetpu.api.wrappers import make_node, make_pod
    from kubetpu.framework import config as KC
    from kubetpu.framework import encode_batch, score_params
    from kubetpu.state.snapshot import Cache

    cache = Cache()
    for i in range(n_nodes):
        cache.add_node(make_node(f"n-{i}", cpu_milli=1000, memory=8 * 1024**3))
    pending = [make_pod(f"p-{j}", cpu_milli=600, memory=128 * 1024**2, creation_index=j)
               for j in range(n_pods)]
    profile = KC.Profile()
    batch = encode_batch(cache.update_snapshot(), pending, profile)
    return batch, score_params(profile, batch.resource_names)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_hash_group_spans_pod_rows(shape):
    """Identical pods on identical nodes form one tie-spread hash group; on
    the grid its 12 pods sit in several pod rows. The rank runs over every
    pod in queue order, so the later rows' pods fan onto nodes the earlier
    rows' pods did not take and one round places all 12, each on its own
    node. Ranked within each row, a later row's pods would pick the first
    row's nodes again and wait for another round."""
    batch, params = _group_batch()
    want = k_batched(batch.device, params)
    b, pp = port_batch_from_jax(batch.device), port_params(params)
    tb = M.shard_batch(b, grid(*shape))
    assert tb.tile(0, 0).requests.shape[0] < 12
    ref_rounds, rounds = [], []
    batched_assign_plain(b, pp, rounds_out=ref_rounds)
    got = batched_assign_tiled_plain(tb, pp, rounds_out=rounds)
    _assert_result(want, got)
    assert rounds == ref_rounds == [1]
    assert sorted(got[0].numpy()[:12].tolist()) == list(range(12))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_tie_across_columns_keeps_the_first_maximum(engine, shape):
    batch, params = _tie_batch()
    kfn = k_greedy if engine == "greedy" else k_batched
    pfn = M.sharded_greedy if engine == "greedy" else M.sharded_batched
    _assert_result(kfn(batch.device, params),
                   pfn(port_batch_from_jax(batch.device), port_params(params), grid(*shape)))


def test_resident_block_is_the_same_on_every_pod_row():
    """The sharded resident block on a grid: tile (i, j) holds column j's
    rows; a routed delta reaches every pod row's copy."""
    from kubetpu_torch.state.snapshot import Cache

    g = grid(2, 2)
    cache = Cache()
    for i in range(30):
        cache.add_node(PW.node_default(i))
    prof = prt.score_params  # noqa: F841  (the encoder's profile below)
    from kubetpu_torch.framework import config as PC

    profile = PC.minimal_profile()
    res = prt.ResidentNodeState("cpu", mesh=g)
    pending = [PW.pod_default(f"p{j}", "ns") for j in range(8)]
    snap = cache.update_snapshot()
    out = prt.encode_batch(snap, pending, profile, resident=res, device="cpu")
    assert out.device.pod_rows == 2 and len(res.shards) == 4
    cache.add_pod(PW.pod_default("dirty", "ns").with_node("scheduler-perf-3"))
    snap = cache.update_snapshot(snap)
    out = prt.encode_batch(snap, pending, profile, prev_nt=out.node_tensors, resident=res,
                           device="cpu")
    assert 0 < res.last_upload_bytes < res.nbytes
    single = prt.ResidentNodeState("cpu")
    prt.encode_batch(snap, pending, profile, resident=single, device="cpu")
    n = single.device.alloc.shape[0]
    for t, shard in enumerate(res.shards):
        j = t % 2
        for f in prt.NODE_FIELDS:
            assert torch.equal(getattr(shard, f),
                               getattr(single.device, f)[j * n // 2:(j + 1) * n // 2]), (t, f)


FACTORIES = {
    "basic": (KW.pod_default, PW.pod_default),
    "spread": (KW.pod_with_topology_spreading, PW.pod_with_topology_spreading),
    "interpod-affinity": (KW.pod_with_pod_affinity, PW.pod_with_pod_affinity),
}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("engine", ["greedy", "batched"])
@pytest.mark.parametrize("name", list(FACTORIES))
def test_scheduler_on_a_grid_binds_as_unsharded(name, engine, shape):
    kf, pf = FACTORIES[name]
    ref, _ = k_run_cluster(None, kf, engine=engine)
    got, s = _port_run(grid(*shape), pf, engine=engine)
    assert got == ref and len(ref) > 0
    assert s.mesh_shape == shape
    assert len(s._resident.shards) == shape[0] * shape[1]
    recs = s.flight_recorder.records_json()["records"]
    assert recs and all(r.get("skipped_reason") == "mesh" for r in recs)


@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_scheduler_on_a_grid_pipelined(engine):
    kf, pf = FACTORIES["spread"]
    ref, _ = k_run_cluster(None, kf, engine=engine)
    got, _ = _port_run(grid(2, 2), pf, engine=engine, pipeline=True)
    assert got == ref


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_preemption_on_a_grid_evicts_as_unsharded(shape):
    """A preempting scheduler on the grid: the dry run runs over the node
    columns of the preempting pod's pod row and evicts the same victim, nominating the same node, as the unsharded
    scheduler (itself held to kubetpu's in ``test_torch_sharded.py``)."""
    from kubetpu_torch.api.wrappers import make_node, make_pod
    from kubetpu_torch.framework import config as PC
    from kubetpu_torch.perf.runner import _Client

    from .torch_port_util import FakeClock

    def run(mesh):
        client = _Client()
        s = PScheduler(client, profile=PC.Profile(), mesh=mesh, device="cpu",
                       clock=FakeClock())
        client.sched = s
        s.enable_preemption()
        for i in range(4):
            s.on_node_add(make_node(f"n{i}", cpu_milli=1000, memory=2**31))
            s.on_pod_add(make_pod(f"low-{i}", cpu_milli=900, priority=i % 2,
                                  node_name=f"n{i}", creation_index=i))
        s.on_pod_add(make_pod("high", cpu_milli=800, priority=100, creation_index=10))
        res = s.schedule_batch()
        return res, sorted(p.name for p, _ in client.deleted), dict(client.nominated)

    ref = run(None)
    assert len(ref[1]) == 1 and ref[2]
    assert run(grid(*shape)) == ref
