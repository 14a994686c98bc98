"""The port's packing engine on a pods x nodes grid equals kubetpu, bit for bit.

Counterparts of kubetpu's ``parallel.sharded_packing(pod_axis="pods")`` on
2x2, 2x4 and 4x2 ``cpu`` grids (``parallel.mesh.make_mesh_2d``): the plain
tiled solve (``assign.packing.packing_assign_tiled_plain``, through
``parallel.mesh.sharded_packing``) against kubetpu's unsharded
``packing_assign_device`` on ``test_torch_packing.py``'s solve scenarios,
and against kubetpu's own grid solve on its virtual CPU devices:
assignments, the seven state slots, λ (its bits), iterations and nodes
used exactly, the objective (float32 sums taken in another order) within
``rtol=1e-5``; every pod row's copy of the node rows and of λ equal. Then
the pod axis's traps: a tie band and an admission segment that span two pod
rows, a rejection in a later pod row that keeps an earlier row's pod of
later admission order from finalizing, and λ's warm start on the grid; and
the scheduler and the perf runner on the packing engine on a grid, serial,
pipelined and with the topology block, pod for pod as unsharded.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax

import kubetpu  # noqa: F401  (x64 on before any kernel runs)
from kubetpu.api import types as KT
from kubetpu.api import wrappers as KWR
from kubetpu.assign import packing as KP
from kubetpu.framework import config as KC
from kubetpu.parallel import make_mesh_2d as k_make_mesh_2d
from kubetpu.parallel import sharded_packing as k_sharded_packing
from kubetpu.state.snapshot import Cache

from kubetpu_torch.assign import packing as PP
from kubetpu_torch.parallel import mesh as M
from kubetpu_torch.perf import run_workload
from kubetpu_torch.perf import workloads as PW

from .test_podaffinity import HOST
from .test_torch_packing import CASES, _bits, _encode
from .test_torch_packing_mesh import _assert_solve, _cluster, _host, _reference
from .torch_port_util import port_batch_from_jax, port_params, to_port

SHAPES = [(2, 2), (2, 4), (4, 2)]
IDS = ["2x2", "2x4", "4x2"]


def grid(pg, ng):
    return M.make_mesh_2d(["cpu"] * (pg * ng), pods=pg)


def _grid_solve(kb, kp, shape, lam=None, max_iters=0, rows=None):
    """The port's solve of kubetpu's batch on a ``cpu`` grid, from ``lam``
    (cold when None) split by tile; ``rows`` receives every pod row's node
    slots."""
    sb = M.shard_batch(port_batch_from_jax(kb), grid(*shape))
    n = sum(int(s.alloc.shape[0]) for s in sb.shards[:sb.columns])
    x = torch.zeros(n) if lam is None else torch.from_numpy(lam.copy())
    w = to_port(KP.PackingWeights()).tensor("cpu")
    return PP.packing_assign_tiled_plain(sb, port_params(kp), M.ShardedTensor.split(x, sb).pieces,
                                         w, max_iters, rows_out=rows)


def _rows_equal(rows, lam):
    """Every pod row's copy of the node rows and of λ equals row 0's."""
    assert len(rows) == lam.rows
    for i, row in enumerate(rows[1:], start=1):
        for x, y in zip(row, rows[0]):
            if x is None:
                assert y is None
                continue
            assert torch.equal(x.cpu(), y.cpu())
        assert torch.equal(lam.row(i).cpu(), lam.row(0).cpu())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_grid_solve_equal_reference(name, shape):
    """Cold, then warm from the cold solve's duals, then truncated after
    one iteration: equal to kubetpu's unsharded solve, the pod rows' copies
    equal."""
    cache, pending, profile, kw = CASES[name]
    kb, kp = _encode(cache, pending, profile, **kw)
    rows = []
    got = _grid_solve(kb.device, kp, shape, rows=rows)
    _assert_solve(_reference(kb.device, kp), got)
    _rows_equal(rows, got[2])
    lam = _host(got[2])
    _assert_solve(_reference(kb.device, kp, lam=lam), _grid_solve(kb.device, kp, shape, lam=lam))
    _assert_solve(_reference(kb.device, kp, max_iters=1),
                  _grid_solve(kb.device, kp, shape, max_iters=1))


@pytest.fixture(scope="module")
def kgrid():
    return k_make_mesh_2d(jax.devices()[:4], pods=2)


@pytest.mark.parametrize("name", ["binpack", "spread-affinity-0", "topology-1"])
def test_kubetpu_grid_packing_equal(kgrid, name):
    """kubetpu's own ``sharded_packing`` with ``pod_axis="pods"`` on a 2x2
    grid of its virtual devices, and the port's ``sharded_packing`` on a
    2x2 ``cpu`` grid: both equal kubetpu's unsharded solve (kubetpu's
    objective within rtol 1e-5, its float32 sums reassociated by GSPMD)."""
    cache, pending, profile, kw = CASES[name]
    kb, kp = _encode(cache, pending, profile, **kw)
    want = _reference(kb.device, kp)
    _assert_solve(want, M.sharded_packing(port_batch_from_jax(kb.device), port_params(kp),
                                          grid(2, 2)))
    ks = jax.device_get(k_sharded_packing(kb.device, kp, kgrid, pod_axis="pods"))
    assert np.array_equal(np.asarray(ks[0]), np.asarray(want[0]))
    assert np.array_equal(_bits(ks[2]), _bits(want[2]))
    assert int(ks[4]) == int(want[4]) and int(ks[5]) == int(want[5])
    assert float(ks[3]) == pytest.approx(float(want[3]), rel=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_tie_band_and_admission_segment_span_pod_rows(shape):
    """Twelve identical pods over four equally loaded open nodes (one tie
    band, one hash group) sit in several pod rows. The first round fans the
    whole group across the band by its rank over every pod, and each
    band node's admission segment takes choosers from two pod rows."""
    cache, pending = _cluster(16, {3: 1, 4: 1, 9: 1, 10: 1}, 12)
    kb, kp = _encode(cache, pending, KC.minimal_profile())
    one = _reference(kb.device, kp, max_iters=1)
    _assert_solve(one, _grid_solve(kb.device, kp, shape, max_iters=1))
    _assert_solve(_reference(kb.device, kp), _grid_solve(kb.device, kp, shape))
    pb = int(kb.device.requests.shape[0]) // shape[0]
    first = np.asarray(one[0])[:12]
    assert sorted(set(first.tolist()) - {-1}) == [3, 4, 9, 10]
    spans = [n for n in (3, 4, 9, 10)
             if len({p // pb for p in np.flatnonzero(first == n)}) > 1]
    assert spans


def _affinity_cluster():
    """Two nodes; pod 0 (priority 0, in pod row 0) needs a pod labeled
    app=a on its host, and none exists yet; four app=a pods of priority 10
    (in the last pod row) are coupled (they feed pod 0's affinity term), so
    a node admits one of them a round and the first round rejects some."""
    cache = Cache()
    for i in range(2):
        cache.add_node(KWR.make_node(f"n{i}", cpu_milli=4000, memory=8 * 1024**3,
                                     labels={HOST: f"n{i}"}))
    term = KT.PodAffinityTerm(HOST, KT.LabelSelector.of({"app": "a"}))
    x = KWR.make_pod("x", cpu_milli=100, memory=64 * 1024**2, creation_index=0,
                     affinity=KT.Affinity(pod_affinity=KT.PodAffinity(required=(term,))))
    fill = [KWR.make_pod(f"f{j}", cpu_milli=100, memory=64 * 1024**2, creation_index=1 + j)
            for j in range(3)]
    gang = [KWR.make_pod(f"a{j}", cpu_milli=100, memory=64 * 1024**2, labels={"app": "a"},
                         priority=10, creation_index=4 + j) for j in range(4)]
    return cache, [x, *fill, *gang]


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_rejection_in_a_later_row_keeps_an_earlier_pod_active(shape):
    """The first rejection is a minimum over ALL pods in admission order:
    the app=a pods rejected in the last pod row precede pod 0 (pod row 0),
    which has no feasible node in the first round, so it must not finalize
    there; once an app=a pod has landed, pod 0 binds beside it. A first
    rejection taken within each pod row would finalize it unplaced."""
    cache, pending = _affinity_cluster()
    kb, kp = _encode(cache, pending, KC.Profile())
    assert int(kb.device.requests.shape[0]) == 8
    want = _reference(kb.device, kp)
    got = _grid_solve(kb.device, kp, shape)
    _assert_solve(want, got)
    a = _host(got[0])
    assert a[0] >= 0 and a[0] in a[4:8]
    assert int(got[4]) >= 2


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_warm_start_on_the_grid(shape):
    """The engine's duals stay a piece a tile across cycles, each on its
    tile's device and equal down the pod rows: the second solve of the same
    batch is warm, and both equal kubetpu's unsharded engine."""
    cache = Cache()
    for i in range(8):
        cache.add_node(KWR.make_node(f"n{i}", cpu_milli=4000, memory=64 * 1024**3))
    pending = [KWR.make_pod(f"p{j}", cpu_milli=900, memory=128 * 1024**2,
                            creation_index=j) for j in range(20)]
    kb, kp = _encode(cache, pending, KC.minimal_profile())
    g = grid(*shape)
    keng, peng = KP.PackingEngine(), PP.PackingEngine(device="cpu", mesh=g)
    sb, pp = M.shard_batch(port_batch_from_jax(kb.device), g), port_params(kp)
    iters = []
    for _ in range(2):
        ka, _ = keng(kb.device, kp)
        pa, _ = peng(sb, pp)
        assert np.array_equal(pa.numpy(), np.asarray(ka))
        assert peng.last_iters == int(keng.last_iters)
        iters.append(peng.last_iters)
    assert iters[1] < iters[0]
    assert (peng.state.carries, peng.state.resets) == (1, 1)
    stored = peng.state._lam[8]
    assert [p.device for p in stored.pieces] == list(g.devices) and stored.rows == shape[0]
    for i in range(1, shape[0]):
        assert torch.equal(stored.row(i).cpu(), stored.row(0).cpu())
    assert np.array_equal(_bits(stored.cpu().numpy()), _bits(keng.state._lam[8]))


def _runs(case, wl, shape, **kw):
    """``case``/``wl`` through the port's runner unsharded and on a grid:
    the two runs' results and bound maps."""
    out = {}
    for tag, mesh in (("ref", None), ("grid", grid(*shape))):
        keep = {}
        res = run_workload(case, wl, device="cpu", engine="packing", mesh=mesh,
                           on_scheduler=lambda s, keep=keep: keep.update(s=s), **kw)
        out[tag] = (res, dict(keep["s"].client.bound), keep["s"])
    return out


_BASIC = PW.Workload("tiny", {"initNodes": 40, "initPods": 20, "measurePods": 60})


@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
@pytest.mark.parametrize("case,wl,shape", [
    ("BinPacking", "200Nodes", (2, 2)),
    ("SchedulingBasic", _BASIC, (2, 4)),
    ("SchedulingBasic", _BASIC, (4, 2)),
], ids=["binpacking-2x2", "basic-2x4", "basic-4x2"])
def test_runner_on_a_grid_binds_as_unsharded(case, wl, shape, pipeline):
    """The packing engine on a grid through the perf runner binds pod for
    pod as the unsharded run, with the same nodes used and solver
    iterations a cycle; the duals are carried across cycles a piece a
    tile."""
    runs = _runs(case, wl, shape, pipeline=pipeline, max_batch=64)
    (ref, rbound, _), (got, gbound, s) = runs["ref"], runs["grid"]
    assert got.scheduled == ref.scheduled > 0
    assert gbound == rbound
    for key in ("nodes_used_at_steady_state", "solver_iters_per_cycle"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.to_json()["mesh_shape"] == list(shape)
    assert s._packing.state.carries >= 1
    assert all(v.rows == shape[0] for v in s._packing.state._lam.values())


def test_runner_on_a_grid_topology_on():
    """BinPacking on a 16-slice fleet with the topology block: the slice
    terms of the penalty and the objective's slices newly opened, on a 2x2
    grid, bind pod for pod as unsharded."""
    runs = _runs("BinPacking", "200Nodes", (2, 2), topology="on", slices=16, max_batch=64)
    (ref, rbound, _), (got, gbound, _) = runs["ref"], runs["grid"]
    assert got.scheduled == ref.scheduled == 300
    assert gbound == rbound
    assert got.nodes_used_at_steady_state == ref.nodes_used_at_steady_state
