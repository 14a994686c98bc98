"""The port's packing engine on a node mesh equals kubetpu's, bit for bit.

Counterparts of kubetpu's ``parallel.sharded_packing`` and its sharded dual
block, on ``cpu`` meshes of G in {2, 4, 8} shards: the solve
(``parallel.mesh.sharded_packing``, the plain
``assign.packing.packing_assign_tiled_plain`` on one pod row) against kubetpu's
unsharded ``packing_assign_device`` and its ``sharded_packing`` on the 8
virtual CPU devices, on ``test_torch_packing.py``'s solve scenarios, with
and without a 32-slice topology: assignments, the seven state slots, λ
(its bits), iterations and nodes used exactly, the objective (float32
sums taken in another order) within ``rtol=1e-5``. Then the traps of the
sharded solve: a tie band that spans a shard boundary, a slice whose nodes
span two shards, the closed-node bias's global index on an empty cluster,
and λ's warm start under the mesh; the scheduler and the perf runner on
the packing engine under a mesh, serial and pipelined, against kubetpu's
unsharded scheduler.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax
import jax.numpy as jnp

import kubetpu  # noqa: F401  (x64 on before any kernel runs)
from kubetpu.api import wrappers as KWR
from kubetpu.assign import packing as KP
from kubetpu.framework import config as KC
from kubetpu.parallel import make_mesh as k_make_mesh
from kubetpu.parallel import sharded_packing as k_sharded_packing
from kubetpu.perf.runner import run_workload as k_run_workload
from kubetpu.state.snapshot import Cache

from kubetpu_torch.assign import packing as PP
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.parallel import mesh as M
from kubetpu_torch.perf import run_workload
from kubetpu_torch.state.topology import SLICE_KEY

from .test_torch_packing import CASES, SCENARIOS, Side, _bits, _encode
from .test_torch_placement import sliced_cluster
from .torch_port_util import port_batch_from_jax, port_params, to_port

GS = [2, 4, 8]


def cpu_mesh(g):
    return M.make_mesh(["cpu"] * g)


def _host(x):
    if x is None:
        return None
    if isinstance(x, M.ShardedTensor):
        x = x.cpu()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_solve(want, got):
    """``got`` (the port's six-tuple) equals ``want`` (kubetpu's, on the
    host): exact but for the objective."""
    ka, kst, klam, kobj, kit, knu = want
    pa, pst, plam, pobj, pit, pnu = got
    assert np.array_equal(_host(pa), np.asarray(ka))
    for i in range(7):
        if kst[i] is None:
            assert pst[i] is None, i
            continue
        h, w = _host(pst[i]), np.asarray(kst[i])
        assert h.dtype == w.dtype and np.array_equal(h, w), i
    assert np.array_equal(_bits(_host(plam)), _bits(klam))
    assert pit == int(kit)
    assert int(pnu) == int(knu)
    assert float(pobj) == pytest.approx(float(kobj), rel=1e-5)


def _reference(kb, kp, lam=None, max_iters=0):
    n = kb.alloc.shape[0]
    lam = np.zeros(n, dtype=np.float32) if lam is None else lam
    return jax.device_get(KP.packing_assign_device(
        kb, kp, jnp.asarray(lam), KP.PackingWeights().tensor(), max_iters=max_iters))


def _port_solve(kb, kp, g, lam=None, max_iters=0):
    """The port's solve of kubetpu's batch over a ``cpu`` mesh of g
    shards, from ``lam`` (cold when None) split by shard."""
    sb = M.shard_batch(port_batch_from_jax(kb), cpu_mesh(g))
    if lam is None:
        return M.sharded_packing(port_batch_from_jax(kb), port_params(kp), cpu_mesh(g),
                                 max_iters=max_iters)
    pieces = M.ShardedTensor([torch.from_numpy(lam[o:o + s.alloc.shape[0]].copy())
                              for s, o in zip(sb.shards, sb.offsets)])
    w = to_port(KP.PackingWeights()).tensor("cpu")
    return PP.packing_assign_device(sb, port_params(kp), pieces, w, max_iters)


@pytest.fixture(scope="module")
def kmesh():
    return k_make_mesh(jax.devices()[:8])


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_solve_equal_reference(name, g):
    """Cold, then warm from the cold solve's duals split by shard, then
    truncated after one iteration: equal to kubetpu's unsharded solve."""
    cache, pending, profile, kw = CASES[name]
    kb, kp = _encode(cache, pending, profile, **kw)
    want = _reference(kb.device, kp)
    got = _port_solve(kb.device, kp, g)
    _assert_solve(want, got)
    lam = _host(got[2])
    _assert_solve(_reference(kb.device, kp, lam=lam), _port_solve(kb.device, kp, g, lam=lam))
    _assert_solve(_reference(kb.device, kp, max_iters=1),
                  _port_solve(kb.device, kp, g, max_iters=1))


@pytest.mark.parametrize("name", ["binpack", "spread-affinity-0", "topology-1"])
def test_kubetpu_sharded_packing_equal(kmesh, name):
    """kubetpu's own ``sharded_packing`` on its 8 virtual devices equals
    its unsharded solve, and the port's on 8 ``cpu`` shards equals both."""
    cache, pending, profile, kw = CASES[name]
    kb, kp = _encode(cache, pending, profile, **kw)
    want = _reference(kb.device, kp)
    _assert_solve(want, _port_solve(kb.device, kp, 8))
    ks = jax.device_get(k_sharded_packing(kb.device, kp, kmesh))
    assert np.array_equal(np.asarray(ks[0]), np.asarray(want[0]))
    assert np.array_equal(_bits(ks[2]), _bits(want[2]))
    assert int(ks[4]) == int(want[4]) and int(ks[5]) == int(want[5])


def _plain_equal_kernel_path(kb, kp, g):
    """The plain sharded solve called directly equals the dispatching
    entry point's result (the CPU shards take the plain version)."""
    sb = M.shard_batch(port_batch_from_jax(kb), cpu_mesh(g))
    pieces = [torch.zeros(s.alloc.shape[0], dtype=torch.float32) for s in sb.shards]
    w = to_port(KP.PackingWeights()).tensor("cpu")
    return PP.packing_assign_tiled_plain(sb, port_params(kp), pieces, w)


def _cluster(n_nodes, bound, n_pending, cpu=1000):
    """``n_nodes`` identical nodes; ``bound`` maps node index to the number
    of 250m pods already there; ``n_pending`` 250m pods pending."""
    cache = Cache()
    for i in range(n_nodes):
        cache.add_node(KWR.make_node(f"n{i:02d}", cpu_milli=cpu, memory=8 * 1024**3))
    k = 0
    for i, count in bound.items():
        for _ in range(count):
            cache.add_pod(KWR.make_pod(f"b{k}", cpu_milli=250, memory=64 * 1024**2,
                                       node_name=f"n{i:02d}"))
            k += 1
    pending = [KWR.make_pod(f"p{j}", cpu_milli=250, memory=64 * 1024**2, creation_index=j)
               for j in range(n_pending)]
    return cache, pending


@pytest.mark.parametrize("g", [2, 4])
def test_tie_band_spans_a_shard_boundary(g):
    """Four equally loaded open nodes either side of the first shard
    boundary form one tie band: the band's pods fan across both shards
    (the tie counts sum over the shards, each shard's pick offset by the
    ties before it)."""
    boundary = 16 // g
    loaded = {boundary - 2: 1, boundary - 1: 1, boundary: 1, boundary + 1: 1}
    cache, pending = _cluster(16, loaded, 12)
    kb, kp = _encode(cache, pending, KC.minimal_profile())
    want = _reference(kb.device, kp)
    got = _port_solve(kb.device, kp, g)
    _assert_solve(want, got)
    first = set(np.asarray(want[0])[:4].tolist())
    assert first & {boundary - 2, boundary - 1} and first & {boundary, boundary + 1}


@pytest.mark.parametrize("g", [4, 8])
def test_slice_spans_two_shards(g):
    """Slices of the 32-node fleet cut across shard boundaries: the slice
    occupancy is a sum over the shards, or a slice busy on one shard would
    read free on the other."""
    cache, pending = sliced_cluster(3, n_nodes=32, slices=3, n_pending=24)
    kb, kp = _encode(cache, pending, KC.Profile(), topology="on")
    topo = kb.device.topology
    sid = np.asarray(topo.slice_id)
    per = 32 // g
    spans = [s for s in range(int(topo.num_slices))
             if len({n // per for n in np.flatnonzero(sid == s)}) > 1]
    assert spans
    _assert_solve(_reference(kb.device, kp), _port_solve(kb.device, kp, g))


@pytest.mark.parametrize("g", GS)
def test_empty_cluster_opens_nodes_in_global_order(g):
    """On an empty cluster the closed-node bias opens bins one a round,
    lowest GLOBAL index first: nodes 0, 1, 2 ... in order. With a shard's
    local index every shard would open its own first row."""
    cache, pending = _cluster(16, {}, 12, cpu=1000)
    kb, kp = _encode(cache, pending, KC.minimal_profile())
    want = _reference(kb.device, kp)
    got = _port_solve(kb.device, kp, g)
    _assert_solve(want, got)
    used = sorted(set(_host(got[0]).tolist()) - {-1})
    assert used == [0, 1, 2]
    plain = _plain_equal_kernel_path(kb.device, kp, g)
    assert np.array_equal(_host(plain[0]), _host(got[0]))


def test_solver_state_holds_one_piece_a_shard():
    mesh = M.make_mesh(["cpu"] * 4)
    st = prt.PackingSolverState(mesh=mesh, device="cpu")
    lam = st.duals(16)
    assert isinstance(lam, M.ShardedTensor) and len(lam.pieces) == 4
    assert [p.shape[0] for p in lam.pieces] == [4] * 4
    assert all(p.device == d for p, d in zip(lam.pieces, mesh.devices))
    st.store(16, M.ShardedTensor([torch.full((4,), 0.5)] * 4))
    assert st.nbytes == 64
    assert float(st.duals(16).cpu().sum()) == pytest.approx(8.0)
    st.store(16, lam)
    st.bind_mesh(mesh)                   # the same mesh keeps the duals
    assert st.nbytes == 64
    st.bind_mesh(M.make_mesh(["cpu"] * 2))   # another layout drops them
    assert st.nbytes == 0
    assert len(st.duals(16).pieces) == 2
    assert (st.resets, st.carries) == (2, 1)
    # a pods x nodes grid: a piece a tile, each column's repeated down the
    # pod rows
    grid = M.make_mesh_2d(["cpu"] * 8, pods=2)
    st.bind_mesh(grid)
    lam = st.duals(16)
    assert len(lam.pieces) == 8 and lam.rows == 2
    assert [p.shape[0] for p in lam.pieces] == [4] * 8
    assert lam.gather().shape == (16,) and len(lam.row(1).pieces) == 4
    st.store(16, lam)
    assert st.nbytes == 128
    with pytest.raises(TypeError, match="resolved mesh"):
        st.bind_mesh("auto")


@pytest.mark.parametrize("g", [2, 4])
def test_warm_start_under_the_mesh(g):
    """The engine's duals stay sharded across cycles: the second solve of
    the same batch is warm (fewer iterations), each piece on its shard's
    device, and both solves equal kubetpu's unsharded engine; a new node
    count starts cold."""
    cache = Cache()
    for i in range(8):
        cache.add_node(KWR.make_node(f"n{i}", cpu_milli=4000, memory=64 * 1024**3))
    pending = [KWR.make_pod(f"p{j}", cpu_milli=900, memory=128 * 1024**2,
                            creation_index=j) for j in range(20)]
    kb, kp = _encode(cache, pending, KC.minimal_profile())
    mesh = cpu_mesh(g)
    keng, peng = KP.PackingEngine(), PP.PackingEngine(device="cpu", mesh=mesh)
    sb, pp = M.shard_batch(port_batch_from_jax(kb.device), mesh), port_params(kp)
    iters = []
    for _ in range(2):
        ka, _ = keng(kb.device, kp)
        pa, _ = peng(sb, pp)
        assert np.array_equal(pa.numpy(), np.asarray(ka))
        assert peng.last_iters == int(keng.last_iters)
        assert int(peng.last_nodes_used) == int(keng.last_nodes_used)
        iters.append(peng.last_iters)
    assert iters[1] < iters[0]
    assert peng.state.carries == 1 and peng.state.resets == 1
    stored = peng.state._lam[8]
    assert [p.device for p in stored.pieces] == list(mesh.devices)
    assert np.array_equal(_bits(stored.cpu().numpy()), _bits(keng.state._lam[8]))
    # a shape change starts cold
    cache.add_node(KWR.make_node("n8", cpu_milli=4000, memory=64 * 1024**3))
    kb2, kp2 = _encode(cache, pending, KC.minimal_profile())
    peng(M.shard_batch(port_batch_from_jax(kb2.device), mesh), port_params(kp2))
    assert peng.state.resets == 2


def _both_mesh(scenario, g, **kw):
    """``scenario`` on kubetpu's unsharded packing scheduler and on the
    port's under a ``cpu`` mesh of g shards: equal results, bound maps and
    solver iterations a cycle, objectives within 1e-5."""
    kside = Side(False, **kw)
    pside = Side(True, mesh=cpu_mesh(g), **kw)
    kres, pres = scenario(kside), scenario(pside)
    assert pres == kres
    assert dict(pside.c.bound) == dict(kside.c.bound)
    assert pside.solver_iters() == kside.solver_iters()
    assert pside.objectives() == pytest.approx(kside.objectives(), rel=1e-5)
    kside.s.close()
    assert pside.s.mesh_shape == (g,)
    return pside, pres


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_scenarios_under_a_mesh(name, g):
    scenario, profile, expected = SCENARIOS[name]
    _, res = _both_mesh(scenario, g, profile=profile)
    assert res == expected


def _fill(side, n_nodes=12, n_pods=64):
    for i in range(n_nodes):
        side.s.on_node_add(side.W.make_node(f"n{i:02d}", cpu_milli=4000,
                                            memory=32 * 1024**3))
    for j in range(n_pods):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=100 + 150 * (j % 5),
                                          memory=256 * 1024**2, creation_index=j))
    return side.settle(8)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
def test_scheduler_packing_under_a_mesh(g, pipeline):
    """Several cycles (warm duals carried between them), serial and
    pipelined, bind pod for pod as kubetpu's unsharded packing scheduler."""
    pside, n = _both_mesh(_fill, g, max_batch=22, pipeline=pipeline)
    assert n == 64 and len(pside.solver_iters()) == 3
    assert pside.s._packing.state.carries >= 1


def _sliced(side):
    """16 nodes in 4 slices of 4 (a slice spans two shards of an 8-shard
    mesh), labeled for the topology block."""
    for i in range(16):
        side.s.on_node_add(side.W.make_node(
            f"n{i:02d}", cpu_milli=2000, memory=16 * 1024**3,
            labels={SLICE_KEY: f"s{i // 4}"}))
    for j in range(24):
        side.s.on_pod_add(side.W.make_pod(f"p{j}", cpu_milli=600, memory=256 * 1024**2,
                                          creation_index=j))
    return side.settle(4)


@pytest.mark.parametrize("g", [4, 8])
@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
def test_scheduler_packing_topology_on_under_a_mesh(g, pipeline):
    pside, n = _both_mesh(_sliced, g, topology="on", max_batch=12, pipeline=pipeline)
    assert n == 24


def test_binpacking_runner_under_a_mesh_equal_unsharded():
    """BinPacking/200Nodes through the port's runner on a 4-shard ``cpu``
    mesh: the bound map, nodes used and solver iterations of the unsharded
    run (and kubetpu's), the mesh's shape stamped."""
    bound = {}

    def keep(tag):
        def on(s):
            bound[tag] = s.client
        return on

    want = k_run_workload("BinPacking", "200Nodes", engine="packing", warmup=False)
    ref = run_workload("BinPacking", "200Nodes", device="cpu", engine="packing",
                       on_scheduler=keep("ref"))
    got = run_workload("BinPacking", "200Nodes", device="cpu", engine="packing",
                       mesh=cpu_mesh(4), on_scheduler=keep("mesh"))
    assert got.scheduled == ref.scheduled == 300
    assert dict(bound["mesh"].bound) == dict(bound["ref"].bound)
    for key in ("nodes_used_at_steady_state", "priority_slo_hit_rate",
                "solver_iters_per_cycle"):
        assert getattr(got, key) == getattr(ref, key) == getattr(want, key), key
    js = got.to_json()
    assert js["mesh_shape"] == [4] and js["n_devices"] == 4


def test_float32_combines_add_in_shard_order():
    """The float32 combines the sharded solve reduces its marginal utility
    and fragmentation sum with: a min is exact in any order; a sum rounds
    after each shard's addition, in shard order (the kernels' combine adds
    the same way), which can differ from one float64 sum rounded once."""
    from kubetpu_torch.ops.reduce import combine

    parts = [torch.tensor([v], dtype=torch.float32) for v in (1.0, 2.0**-24, 2.0**-24)]
    got = combine("sum", parts)
    want = (parts[0] + parts[1]) + parts[2]
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert float(got) != float(sum(float(p) for p in parts))
    mins = [torch.tensor([x], dtype=torch.float32) for x in (0.5, -1.25, float("inf"))]
    assert float(combine("min", mins)) == -1.25
    assert float(combine("max", mins)) == float("inf")
