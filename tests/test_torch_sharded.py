"""The port's sharded scheduler equals kubetpu's, pod for pod.

Counterparts of ``tests/test_sharded.py``'s nine tests, on ``cpu`` meshes
of G in {2, 4, 8} shards (kubetpu on its 8 virtual CPU devices): the
scheduler's bound maps on the greedy and batched engines, pipelined, with
a node added and one deleted mid-run; the sharded resident block's routed
delta uploads, incremental reshard and clean-row skip; the preemption dry
run under a mesh and a preempting scheduler. Plus the option a mesh does
not take yet (the gang lane), which raises naming item 12.
"""

import numpy as np
import pytest
import torch

from kubetpu.api.wrappers import make_node as k_make_node
from kubetpu.api.wrappers import make_pod as k_make_pod
from kubetpu.framework import config as KC
from kubetpu.parallel import make_mesh as k_make_mesh
from kubetpu.perf import workloads as KW

from kubetpu_torch.api.wrappers import make_node, make_pod
from kubetpu_torch.framework import config as PC
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.parallel import mesh as M
from kubetpu_torch.perf import workloads as PW
from kubetpu_torch.sched import Scheduler as PScheduler
from kubetpu_torch.state.snapshot import Cache

from .test_sharded import _run_cluster as k_run_cluster
from .torch_port_util import FakeClock, RecordingClient

import jax

GS = [2, 4, 8]


@pytest.fixture(scope="module")
def kmesh():
    return k_make_mesh(jax.devices()[:8])


def cpu_mesh(g):
    return M.make_mesh(["cpu"] * g)


def _drive(s, client, pods, max_batch=8, events=None):
    for p in pods:
        s.on_pod_add(p)
    calls = idle = 0
    while idle < 3 and calls < 200:
        if events and calls in events:
            events[calls](s)
        res = s.schedule_batch(max_batch)
        calls += 1
        idle = 0 if (res["scheduled"] or res["unschedulable"]) else idle + 1
    if s._inflight is not None:
        s._complete_inflight()
    return dict(client.bound)


def _port_run(mesh_arg, factory, engine="greedy", pipeline=False, events=None,
              num_pods=32):
    """The port's twin of test_sharded._run_cluster."""
    client = RecordingClient()
    s = PScheduler(client, profile=PC.Profile(), mesh=mesh_arg, engine=engine,
                   pipeline=pipeline, max_batch=8, device="cpu", clock=FakeClock())
    for i in range(12):
        s.on_node_add(PW.node_default(i, zones=("z-a", "z-b", "z-c")))
    s.on_pod_add(make_pod(
        "seed-0", namespace="sched-0", labels={"color": "blue"},
        cpu_milli=100, memory=100 * 1024**2, node_name="scheduler-perf-0",
    ))
    pods = [factory(f"p-{j}", "sched-0") for j in range(num_pods)]
    bound = _drive(s, client, pods, events=events)
    return bound, s


FACTORIES = {
    "basic": (KW.pod_default, PW.pod_default),
    "spread": (KW.pod_with_topology_spreading, PW.pod_with_topology_spreading),
    "interpod-affinity": (KW.pod_with_pod_affinity, PW.pod_with_pod_affinity),
}


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("engine", ["greedy", "batched"])
@pytest.mark.parametrize("shape", list(FACTORIES))
def test_sharded_scheduler_pod_for_pod_parity(kmesh, shape, engine, g):
    kf, pf = FACTORIES[shape]
    ref, _ = k_run_cluster(None, kf, engine=engine)
    kgot, _ = k_run_cluster(kmesh, kf, engine=engine)
    assert kgot == ref and len(ref) > 0
    got, s = _port_run(cpu_mesh(g), pf, engine=engine)
    assert got == ref
    # the resident block lives in G shards, one per mesh device
    assert s._resident.shards is not None and len(s._resident.shards) == g
    assert s.mesh_shape == (g,)
    t = s.metrics.cycle_timings[-1]
    assert t.mesh_shape == (g,) and t.collective_wall_s is not None
    # the recorder's records say why they carry no breakdown
    recs = s.flight_recorder.records_json()["records"]
    assert recs and all(r.get("skipped_reason") == "mesh" for r in recs)


@pytest.mark.parametrize("g", GS)
def test_sharded_pipelined_parity(g):
    ref, _ = k_run_cluster(None, KW.pod_with_topology_spreading, pipeline=True)
    got, _ = _port_run(cpu_mesh(g), PW.pod_with_topology_spreading, pipeline=True)
    assert got == ref and len(ref) > 0


@pytest.mark.parametrize("g", GS)
def test_sharded_parity_with_mid_run_node_add_delete(g):
    def k_add(s):
        s.on_node_add(KW.node_default(12, zones=("z-a", "z-b", "z-c")))

    def k_del(s):
        s.on_node_delete(s.cache.get_node_info("scheduler-perf-3").node)

    def p_add(s):
        s.on_node_add(PW.node_default(12, zones=("z-a", "z-b", "z-c")))

    def p_del(s):
        s.on_node_delete(s.cache.get_node_info("scheduler-perf-3").node)

    ref, _ = k_run_cluster(None, KW.pod_default, events={2: k_add, 4: k_del})
    got, _ = _port_run(cpu_mesh(g), PW.pod_default, events={2: p_add, 4: p_del})
    assert got == ref and len(ref) > 0


# ---------------------------------------------------------------------------
# the sharded resident block: routed deltas, incremental reshard
# ---------------------------------------------------------------------------

def _encode_state(num_nodes=10, num_pods=6):
    cache = Cache()
    for i in range(num_nodes):
        cache.add_node(make_node(f"n{i}", cpu_milli=8000, memory=16 * 1024**3))
    pods = [make_pod(f"p{j}", cpu_milli=500, memory=512 * 1024**2)
            for j in range(num_pods)]
    return cache, pods


def _node_block(b):
    """The node block of a (sharded) device batch, joined on the host."""
    if hasattr(b, "shards"):
        return {f: torch.cat([getattr(s.nodes, f) for s in b.shards]).numpy()
                for f in prt.NODE_FIELDS}
    return {f: getattr(b.nodes, f).numpy() for f in prt.NODE_FIELDS}


def _assert_block_equal(b, ref, tag):
    got, want = _node_block(b), _node_block(ref)
    for f in prt.NODE_FIELDS:
        assert np.array_equal(got[f], want[f]), f"{tag}:{f}"


def test_sharded_delta_upload_routed_per_shard():
    """Dirty rows go to their owning shard only, with shard-local
    indices; the blocks equal a fresh unsharded encode; the per-shard byte
    accounting sums to the total."""
    mesh = cpu_mesh(8)
    cache, pods = _encode_state(num_nodes=16)
    profile = PC.Profile()
    resident = prt.ResidentNodeState("cpu", mesh=mesh)
    snap = cache.update_snapshot()
    b1 = prt.encode_batch(snap, pods, profile, resident=resident, device="cpu")
    assert b1.resident_bytes > 0 and len(b1.device.shards) == 8
    cache.add_pod(make_pod("placed-a", cpu_milli=1500, memory=1024**3, node_name="n1"))
    cache.add_pod(make_pod("placed-b", cpu_milli=700, memory=1024**3, node_name="n14"))
    snap = cache.update_snapshot(snap)
    b2 = prt.encode_batch(snap, pods, profile, prev_nt=b1.node_tensors,
                          resident=resident, device="cpu")
    full = sum(v.nbytes for v in _node_block(b2.device).values())
    assert 0 < resident.last_upload_bytes < full
    assert sum(resident.last_upload_bytes_per_shard) == resident.last_upload_bytes
    assert resident.last_rows_per_shard[1 // 2] == 1      # n1 -> shard 0
    assert resident.last_rows_per_shard[14 // 2] == 1     # n14 -> shard 7
    assert sum(resident.last_rows_per_shard) == 2
    # the other shards received nothing
    assert [x > 0 for x in resident.last_upload_bytes_per_shard] == [
        True, False, False, False, False, False, False, True]
    ref = prt.encode_batch(cache.update_snapshot(), pods, profile, device="cpu")
    _assert_block_equal(b2.device, ref.device, "delta")


@pytest.mark.parametrize("use_mesh", [False, True], ids=["single", "mesh"])
def test_incremental_reshard_on_node_add_delete(use_mesh):
    mesh = cpu_mesh(8) if use_mesh else None
    cache, pods = _encode_state(num_nodes=10)   # pads to 16: room to grow
    profile = PC.Profile()
    resident = prt.ResidentNodeState("cpu", mesh=mesh)
    snap = cache.update_snapshot()
    b1 = prt.encode_batch(snap, pods, profile, resident=resident, device="cpu")
    full = resident.last_upload_bytes
    assert full > 0
    cache.add_node(make_node("n10", cpu_milli=2000, memory=4 * 1024**3))
    snap = cache.update_snapshot(snap)
    b2 = prt.encode_batch(snap, pods, profile, prev_nt=b1.node_tensors,
                          resident=resident, device="cpu")
    assert b2.node_tensors is b1.node_tensors
    assert 0 < resident.last_upload_bytes < full
    _assert_block_equal(b2.device, prt.encode_batch(
        cache.update_snapshot(), pods, profile, device="cpu").device, "add")
    cache.remove_node("n5")
    snap = cache.update_snapshot(snap)
    b3 = prt.encode_batch(snap, pods, profile, prev_nt=b2.node_tensors,
                          resident=resident, device="cpu")
    assert 0 < resident.last_upload_bytes
    _assert_block_equal(b3.device, prt.encode_batch(
        cache.update_snapshot(), pods, profile, device="cpu").device, "del")


def test_reshard_skips_clean_rows():
    mesh = cpu_mesh(8)
    cache, pods = _encode_state(num_nodes=16)
    resident = prt.ResidentNodeState("cpu", mesh=mesh)
    snap = cache.update_snapshot()
    b1 = prt.encode_batch(snap, pods, PC.Profile(), resident=resident, device="cpu")
    cache.update_node(make_node("n7", cpu_milli=9000, memory=16 * 1024**3))
    snap = cache.update_snapshot(snap)
    b2 = prt.encode_batch(snap, pods, PC.Profile(), prev_nt=b1.node_tensors,
                          resident=resident, device="cpu")
    limit = 2 if b2.node_tensors is b1.node_tensors else 4
    assert sum(resident.last_rows_per_shard) <= limit


# ---------------------------------------------------------------------------
# the preemption dry run under a mesh
# ---------------------------------------------------------------------------

def _preemption_problem():
    from kubetpu.api import types as KT
    from kubetpu.framework import runtime as krt
    from kubetpu.state import Cache as KCache

    cache = KCache()
    for i in range(8):
        cache.add_node(k_make_node(f"n{i}", cpu_milli=1000, memory=2 * 1024**3, pods=8))
        cache.add_pod(k_make_pod(
            f"low-{i}", cpu_milli=900, memory=1024**3, priority=i % 3,
            node_name=f"n{i}", labels={"app": "victim"}, creation_index=i,
        ))
    pdb = KT.PodDisruptionBudget(
        name="pdb", selector=KT.LabelSelector.of({"app": "victim"}),
        disruptions_allowed=4,
    )
    pending = [k_make_pod("high", cpu_milli=800, memory=1024**3, priority=100,
                          creation_index=99)]
    profile = KC.Profile()
    batch = krt.encode_batch(cache.update_snapshot(), pending, profile)
    return batch, krt.score_params(profile, batch.resource_names), (pdb,)


@pytest.mark.parametrize("g", GS)
def test_sharded_preemption_dry_run_bit_parity(g):
    """Each shard's rows through the dry run, the shards' best tuples
    reduced with -global index: the same node, victims, ok and PDB counts
    as kubetpu's unsharded dry run."""
    import jax.numpy as jnp
    from kubetpu.framework.preemption import PreemptionEvaluator
    from kubetpu.ops import preemption as KOP

    from kubetpu_torch.ops import preemption as POP

    batch, params, pdbs = _preemption_problem()
    ev = PreemptionEvaluator(batch, params, pdbs=pdbs)
    b = batch.device
    v = ev.victims
    wants_conf = jnp.einsum("k,kl->l", b.pod_ports[0].astype(jnp.int32),
                            b.port_conflict.astype(jnp.int32)) > 0
    potential = ev._potential_mask(0)
    args = (b.requests[0], jnp.asarray(np.int64(100)), wants_conf, potential,
            b.alloc, ev.requested, ev.pod_count, b.allowed_pods, ev.port_counts,
            v.valid, v.priority, v.start, v.requests, v.victim_ports, v.pdb,
            jnp.asarray(ev.pdb_allowed))
    # kubetpu's dry run donates two of its inputs: copy them all first
    t = [torch.from_numpy(np.array(x)) for x in args]
    t[1] = 100
    ref = KOP.dry_run_preemption(*args)
    n = t[4].shape[0]
    per = n // g
    node_rows = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14}
    shard_args = [
        tuple(x[k * per:(k + 1) * per] if j in node_rows else x for j, x in enumerate(t))
        for k in range(g)
    ]
    got = POP.dry_run_preemption_sharded(shard_args, [k * per for k in range(g)])
    assert int(got[0]) == int(np.asarray(ref[0])) >= 0
    for name, w, x in zip(("victims", "ok", "n_pdb"), ref[1:], got[1:]):
        assert np.array_equal(x.cpu().numpy(), np.asarray(w)), name


@pytest.mark.parametrize("g", GS)
def test_sharded_scheduler_preemption_parity(g):
    """A preempting scheduler under the mesh evicts the same victim as
    kubetpu's single-device one."""
    from kubetpu.sched import Scheduler as KScheduler

    from .test_scheduler import FakeClient

    def run_k():
        deleted = []

        class Client(FakeClient):
            def delete_pod(self, pod, reason=""):
                deleted.append(pod.name)

            def nominate(self, pod, node_name):
                pass

        s = KScheduler(client=Client(), profile=KC.Profile(), dispatcher_workers=0,
                       clock=FakeClock())
        s.enable_preemption()
        for i in range(4):
            s.on_node_add(k_make_node(f"n{i}", cpu_milli=1000, memory=2**31))
            s.on_pod_add(k_make_pod(f"low-{i}", cpu_milli=900, priority=i % 2,
                                    node_name=f"n{i}", creation_index=i))
        s.on_pod_add(k_make_pod("high", cpu_milli=800, priority=100, creation_index=10))
        res = s.schedule_batch()
        s.dispatcher.sync()
        s.close()
        return res, sorted(deleted)

    def run_p():
        from kubetpu_torch.perf.runner import _Client

        client = _Client()
        s = PScheduler(client, profile=PC.Profile(), mesh=cpu_mesh(g), device="cpu",
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

    ref_res, ref_deleted = run_k()
    got_res, got_deleted, nominated = run_p()
    assert got_res == ref_res
    assert got_deleted == ref_deleted and len(ref_deleted) == 1
    # the preemptor is nominated to its victim's node
    assert list(nominated.values()) == ["n" + ref_deleted[0].split("-")[1]]


def test_multichip_smoke_on_a_cpu_mesh():
    """The whole loop over an 8-shard cpu mesh: the cycle schedules every
    pod and its timing carries the mesh and each shard's upload share."""
    client = RecordingClient()
    s = PScheduler(client, profile=PC.minimal_profile(), mesh=cpu_mesh(8), device="cpu",
                   clock=FakeClock())
    for i in range(8):
        s.on_node_add(make_node(f"n{i}", cpu_milli=4000, memory=8 * 1024**3))
    for j in range(16):
        s.on_pod_add(make_pod(f"p{j}", cpu_milli=500, memory=256 * 1024**2,
                              creation_index=j))
    assert s.schedule_batch()["scheduled"] == 16
    t = s.metrics.cycle_timings[-1]
    assert t.mesh_shape == (8,)
    assert t.shard_upload_bytes is not None and sum(t.shard_upload_bytes) > 0


@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_run_workload_under_a_cpu_mesh_binds_as_unsharded(engine):
    """The perf runner's ``mesh=``: SchedulingBasic's smallest workload
    binds pod for pod as the unsharded run, and the result carries the
    mesh's shape, shard count and probe."""
    from kubetpu_torch.perf import run_workload
    from kubetpu_torch.perf import workloads as W

    wl = W.Workload("tiny", {"initNodes": 40, "initPods": 20, "measurePods": 60})
    bound = {}

    def keep(tag):
        def on(s):
            bound[tag] = s.client
        return on

    ref = run_workload("SchedulingBasic", wl, device="cpu", engine=engine,
                       max_batch=32, on_scheduler=keep("ref"))
    got = run_workload("SchedulingBasic", wl, device="cpu", engine=engine,
                       max_batch=32, mesh=cpu_mesh(4), on_scheduler=keep("mesh"))
    assert got.scheduled == ref.scheduled == 60
    assert dict(bound["mesh"].bound) == dict(bound["ref"].bound)
    js = got.to_json()
    assert js["mesh_shape"] == [4] and js["n_devices"] == 4
    assert js["collective_wall_s"] >= 0.0


def test_extenders_under_a_cpu_mesh_bind_as_unsharded():
    """A filter + prioritize webhook's (P, N) verdicts are cut by node onto
    the shards (``ShardedBatch.replace_pod_node``): the bound map equals
    the unsharded scheduler's, and no pod lands on a rejected node."""
    from .test_extender_client import ScriptedExtender
    from .torch_port_util import to_port

    ext = ScriptedExtender(reject={"n0", "n3"}, prefer="n5")
    try:
        profile = KC.minimal_profile()
        cfg = to_port(KC.SchedulerConfiguration(
            profiles=(profile,),
            extenders=(KC.ExtenderConfig(
                url_prefix=ext.url, filter_verb="filter", prioritize_verb="prioritize",
                weight=5, node_cache_capable=True),)))

        def run(mesh):
            client = RecordingClient()
            s = PScheduler(client, profile=to_port(profile), cfg=cfg, mesh=mesh,
                           device="cpu", clock=FakeClock())
            for i in range(8):
                s.on_node_add(make_node(f"n{i}", cpu_milli=4000))
            for j in range(6):
                s.on_pod_add(make_pod(f"p{j}", cpu_milli=1500, creation_index=j))
            s.schedule_batch()
            s.schedule_batch()
            s.close()
            return dict(client.bound)

        ref = run(None)
        assert run(cpu_mesh(4)) == ref
        assert len(ref) == 6 and not set(ref.values()) & {"n0", "n3"}
    finally:
        ext.close()
