"""The port's gang lane under a mesh equals kubetpu's, bit for bit.

kubetpu's group cycles encode their batch without the mesh
(``kubetpu/sched/podgroup.py:409-414``, ``:475-479``): under any mesh each
group batch is unsharded on the default device, and the placement search,
the gang dry run and the coalesced cycle's engine run unsharded while the
per-pod cycles stay sharded. The port does the same on the mesh's first
device. Here the port's ``Scheduler(mesh=...)`` on a 4-shard ``cpu`` node
mesh, a 2x2 ``cpu`` grid and a 3-shard node mesh (whose padded node count,
a multiple of 3, differs from the group encode's) runs gangs against
kubetpu's ``Scheduler`` under a virtual-CPU mesh of the same shape, and
against the port's unsharded run: the GangScheduling workloads on the
three engines, topology-labeled placement cycles, gang preemption, gangs
mixed with plain pods on the packing engine (the duals carried across the
group and per-pod cycles: their values, resets and carries), and the
sharded resident block after a group cycle has bound.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax

from kubetpu.api import wrappers as KWR
from kubetpu.framework import config as KC
from kubetpu.parallel import make_mesh as k_make_mesh
from kubetpu.parallel import make_mesh_2d as k_make_mesh_2d
from kubetpu.perf import workloads as KW
from kubetpu.perf.runner import _Client as KClient
from kubetpu.sched.scheduler import Scheduler as KScheduler

from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.parallel import mesh as M
from kubetpu_torch.perf import run_workload
from kubetpu_torch.state.encoder import encode_snapshot
from kubetpu_torch.state.topology import SLICE_KEY

from .test_torch_packing import _bits
from .test_torch_podgroup import Side, _gang_record

MESHES = ["1d-4", "2x2", "1d-3"]


def port_mesh(kind):
    if kind == "2x2":
        return M.make_mesh_2d(["cpu"] * 4, pods=2)
    return M.make_mesh(["cpu"] * int(kind[-1]))


def k_mesh(kind):
    if kind == "2x2":
        return k_make_mesh_2d(jax.devices()[:4], pods=2)
    return k_make_mesh(jax.devices()[:int(kind[-1])])


def _k_gang_run(workload, engine, mesh, slices=0, topology="off"):
    """kubetpu's Scheduler driven through GangScheduling's ops (as
    ``test_torch_podgroup.test_gang_workload_bound_map_equal`` drives it),
    under ``mesh``: its bound map."""
    tc = KW.TEST_CASES["GangScheduling"]
    params = next(w for w in tc.workloads if w.name == workload).params
    extra = {"TopologyAwareWorkloadScheduling": True} if slices else {}
    client = KClient()
    sched = KScheduler(client, profile=KC.Profile(), dispatcher_workers=0, engine=engine,
                       feature_gates={**dict(tc.feature_gates), **extra}, topology=topology,
                       mesh=mesh)
    client.sched = sched
    for i in range(params["initNodes"]):
        sched.on_node_add(KW.node_default(i, (), slices))
    groups, per = params["initPodGroups"], params["podsPerGroup"]
    for g in range(groups):
        sched.on_pod_group_add(KWR.make_pod_group(f"gang-{g}", namespace="gang-0",
                                                  min_count=per))
    for j in range(groups * per):
        sched.on_pod_add(KWR.make_pod(
            f"gangpod-{j}", namespace="gang-0", cpu_milli=100, memory=100 * 1024**2,
            scheduling_group=f"gang-{j // per}", creation_index=j))
    for _ in range(20):
        if client.bound_by_ns["gang-0"] >= groups * per:
            break
        sched.schedule_batch()
        sched.dispatcher.sync()
        client.deliver()
    return dict(client.bound)


def _p_gang_run(workload, engine, mesh, slices=0, topology="off"):
    extra = {"TopologyAwareWorkloadScheduling": True} if slices else {}
    keep = {}
    res = run_workload("GangScheduling", workload, device="cpu", engine=engine, mesh=mesh,
                       feature_gates=extra, topology=topology, slices=slices,
                       on_scheduler=lambda s: keep.update(s=s))
    return res, keep["s"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("engine", ["greedy", "batched", "packing"])
@pytest.mark.parametrize("workload", ["10Nodes_3Gangs", "100Nodes_10Gangs"])
def test_gang_workload_under_a_mesh(workload, engine, mesh):
    """GangScheduling on each engine under the mesh binds what kubetpu's
    scheduler under a mesh of the same shape binds, and what the port's
    unsharded run binds; the group cycles ran on unsharded batches. On
    the packing engine under 3 node shards kubetpu's first group solve
    fails (it places cold duals of the group batch's 16 or 128 rows
    sharded 3 ways); the port starts them unsharded and binds as its
    unsharded run."""
    ref, ref_s = _p_gang_run(workload, engine, None)
    if engine == "packing" and mesh == "1d-3":
        with pytest.raises(ValueError, match="divisible by 3"):
            _k_gang_run(workload, engine, k_mesh(mesh))
        want = dict(ref_s.client.bound)
    else:
        want = _k_gang_run(workload, engine, k_mesh(mesh))
    got, s = _p_gang_run(workload, engine, port_mesh(mesh))
    assert len(want) == got.scheduled == got.measure_pods
    assert dict(s.client.bound) == dict(ref_s.client.bound) == want
    assert got.group_cycles == ref.group_cycles >= 1
    assert s.mesh_shape == port_mesh(mesh).shape


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_placement_cycles_under_a_mesh(engine, mesh):
    """Topology-labeled gangs (a 4-slice fleet, the placement gate on) run
    the placement search on the unsharded group batch: one group cycle a
    gang, each gang on one slice, bound as kubetpu under its mesh."""
    want = _k_gang_run("10Nodes_3Gangs", engine, k_mesh(mesh), slices=4, topology="on")
    got, s = _p_gang_run("10Nodes_3Gangs", engine, port_mesh(mesh), slices=4, topology="on")
    assert dict(s.client.bound) == want and got.scheduled == len(want)
    assert got.group_cycles == 3
    snap, slices = s.cache.update_snapshot(), {}
    for key, node in dict(s.client.bound).items():
        gang = int(key.rsplit("-", 1)[1]) // 3
        slices.setdefault(gang, set()).add(snap.nodes[node].node.labels_dict().get(SLICE_KEY))
    assert all(len(v) == 1 for v in slices.values())


def _pair(scenario, mesh, **kw):
    """``scenario`` on kubetpu under its mesh and on the port under the
    same shape: equal results, bound maps and deletes. Returns both
    sides."""
    kside = Side(False, mesh=k_mesh(mesh), **kw)
    pside = Side(True, mesh=port_mesh(mesh), **kw)
    kres, pres = scenario(kside), scenario(pside)
    assert pres == kres
    assert dict(pside.c.bound) == dict(kside.c.bound)
    assert ([k for k, _, _ in pside.c.deleted] == [k for k, _, _ in kside.c.deleted])
    return kside, pside, pres


@pytest.mark.parametrize("mesh", ["1d-4", "2x2"])
def test_gang_preemption_under_a_mesh(mesh):
    """``tests/test_topology.py:208``'s scenario: a train gang evicts the
    one low-priority gang on a slice and lands there, under the mesh as
    kubetpu does (the gang dry run on the unsharded group batch)."""
    def scenario(x):
        x.s.enable_preemption()
        for sval, names in (("s0", ("a0", "a1")), ("s1", ("b0", "b1"))):
            for n in names:
                x.sliced(n, sval)
        x.group("low", min_count=2)
        for i in range(2):
            x.add(f"low-{i}", "low", cpu=900, prio=0, idx=i)
        steps = [x.settle()]
        for j in range(2):
            x.s.on_pod_add(x.W.make_pod(f"serve-{j}", cpu_milli=900, priority=10,
                                        creation_index=10 + j))
        steps.append(x.settle())
        x.group("train", min_count=2)
        for i in range(2):
            x.add(f"train-{i}", "train", cpu=900, prio=8, idx=20 + i)
        steps.append(x.settle())
        rec = _gang_record(x, "default/train")
        for _k, _r, p in list(x.c.deleted):
            x.s.on_pod_delete(p)
        x.clock.tick(30)
        steps.append(x.settle())
        return steps, rec["status"], rec["victim_group"]

    _, pside, (steps, status, victim) = _pair(scenario, mesh, topology="on")
    assert steps == [2, 2, 0, 2] and status == "preempting" and victim == "default/low"
    assert [k for k, _, _ in pside.c.deleted] == ["default/low-0", "default/low-1"]


def _mixed_packing(x):
    """Plain pods and unlabeled gangs on the packing engine: per-pod and
    coalesced group cycles in turn, each solve taking the duals the last
    one left for its padded capacity."""
    for i in range(6):
        x.node(f"n{i}", cpu=2000)
    for j in range(5):
        x.s.on_pod_add(x.W.make_pod(f"p{j}", cpu_milli=300, memory=128 * 1024**2,
                                    creation_index=j))
    first = x.settle(2)
    for g in range(2):
        x.group(f"gang-{g}", min_count=3)
        for i in range(3):
            x.add(f"g{g}-{i}", f"gang-{g}", cpu=400, idx=10 + 3 * g + i)
    second = x.settle(3)
    for j in range(5, 9):
        x.s.on_pod_add(x.W.make_pod(f"p{j}", cpu_milli=300, memory=128 * 1024**2,
                                    creation_index=30 + j))
    return first, second, x.settle(3)


def _engine(side):
    return side.s._packing if side.port else side.s._assign_device


@pytest.mark.parametrize("mesh", MESHES)
def test_packing_duals_carried_across_group_cycles(mesh):
    """Mixed gang and plain pods on the packing engine under the mesh: the
    bound map, and the duals kubetpu's engine holds (their bits, per padded
    capacity), its resets and carries, are the port's."""
    kside, pside, res = _pair(_mixed_packing, mesh, engine="packing")
    assert sum(res) == 15
    keng, peng = _engine(kside), _engine(pside)
    assert (peng.state.resets, peng.state.carries) == (keng.state.resets, keng.state.carries)
    assert peng.state.carries >= 2
    assert sorted(peng.state._lam) == sorted(keng.state._lam)
    for n, lam in keng.state._lam.items():
        mine = peng.state._lam[n]
        mine = mine.cpu() if isinstance(mine, M.ShardedTensor) else mine
        assert np.array_equal(_bits(mine.numpy()), _bits(np.asarray(lam))), n


@pytest.mark.parametrize("mesh", ["1d-4", "2x2", "1d-3"])
def test_resident_block_after_a_group_cycle(mesh):
    """A group cycle binds on an unsharded batch and leaves the rows it
    dirtied pending: the next per-pod cycle's refresh brings the sharded
    resident block to the snapshot, equal to a fresh upload of it (a pod
    no node fits runs that cycle and assumes nothing)."""
    side = Side(True, mesh=port_mesh(mesh))
    for i in range(10):
        side.node(f"n{i}", cpu=2000)
    side.s.on_pod_add(side.W.make_pod("warm", cpu_milli=100, creation_index=0))
    assert side.settle(1) == 1
    side.group("gang-a", min_count=4)
    for i in range(4):
        side.add(f"g-{i}", "gang-a", cpu=700, idx=1 + i)
    assert side.settle(2) == 4
    side.s.on_pod_add(side.W.make_pod("huge", cpu_milli=10**6, creation_index=9))
    side.settle(1)
    s = side.s
    nt = encode_snapshot(s.cache.update_snapshot(), resource_names=s._prev_nt.resource_names,
                         pad_nodes=s._prev_nt.alloc.shape[0])
    fresh = prt.ResidentNodeState("cpu", mesh=s.mesh)
    fresh.refresh(nt, len(nt.node_names))
    assert len(s._resident.shards) == len(fresh.shards) == s.mesh.size
    for mine, want in zip(s._resident.shards, fresh.shards):
        for f in prt.NODE_FIELDS:
            assert torch.equal(getattr(mine, f), getattr(want, f)), f
    assert int(sum(int(x.pod_count.sum()) for x in s._resident.shards[:s.mesh.node_shards])) == 5


def test_three_shard_padding_differs():
    """On 3 node shards the per-pod cycles pad 10 nodes to 18 rows (16
    rounded up to a multiple of 3) and the first group cycle's encode to
    16: the group cycle runs on its own capacity, then the per-pod cycle
    rebuilds the node tensors at 18."""
    side = Side(True, mesh=port_mesh("1d-3"))
    for i in range(10):
        side.node(f"n{i}", cpu=2000)
    side.group("gang-a", min_count=2)
    for i in range(2):
        side.add(f"g-{i}", "gang-a", cpu=500, idx=i)
    assert side.settle(1) == 2
    assert side.s._prev_nt.alloc.shape[0] == 16
    side.s.on_pod_add(side.W.make_pod("p", cpu_milli=100, creation_index=5))
    assert side.settle(1) == 1
    assert side.s._prev_nt.alloc.shape[0] == 18
    assert [b.alloc.shape[0] for b in side.s._resident.shards] == [6, 6, 6]
