"""The port's resident node block, its row scatter (B5) and the pipelined
cycle, held to kubetpu's on the CPU.

Modelled on ``tests/test_pipeline.py``:

- ``scatter_node_rows_plain`` (the plain version of the ``scatter_rows``
  kernel) writes exactly what kubetpu's ``_scatter_node_rows`` writes, pad
  indices dropped; the kernel's launch plan takes a CUDA block only;
- a delta refresh of the resident block equals a full re-encode and ships
  the bytes kubetpu's ships; a clean refresh ships none; the dense-update
  fallback and the incremental reshard on node add and delete behave as
  kubetpu's; a delta rides the pod leaves' host→device copy (one copy a
  cycle), and only a full upload is a copy of its own; ``refresh_static``
  rejects a changed node set;
- the pipelined cycle binds pod for pod as the serial loop and as kubetpu's
  pipelined cycle on the SchedulingBasic, topology-spread, inter-pod
  affinity, preferred-spread and anti-affinity shapes (the last two fail if
  the affinity or spread encode runs in stage 1, before the previous
  batch's assumes land); a node update mid-pipeline is replayed (and keeps
  parity); bind confirmations are not;
- the serial cycle on the defaults ships only dirty node rows once the
  block is resident, and times its node encode's sub-spans; the runner's
  garbage-collector clock counts what falls inside it.

Tolerance: exact throughout.
"""

import gc

import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
import jax.numpy as jnp
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.state.snapshot import Cache

from kubetpu_torch import kernels
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.perf import run_workload
from kubetpu_torch.perf.runner import _GcClock

from .torch_port_util import drive, port_cache, scheduler_pair, to_port


# ------------------------------------------------------------- B5 scatter

def _block(rng, n, r):
    return (
        rng.integers(0, 1 << 40, (n, r)).astype(np.int64),
        rng.integers(0, 1 << 40, (n, r)).astype(np.int64),
        rng.integers(0, 1 << 40, (n, r)).astype(np.int64),
        rng.integers(0, 110, n).astype(np.int32),
        rng.integers(0, 110, n).astype(np.int32),
        rng.random(n) < 0.7,
    )


@pytest.mark.parametrize("seed,n_rows,n_pad", [(0, 5, 3), (1, 17, 15), (2, 1, 0)])
def test_scatter_plain_equals_kubetpu(seed, n_rows, n_pad):
    """Distinct dirty rows in shuffled order, then pads equal to N (the
    reference's) and past it: the pads are dropped, the rows written."""
    rng = np.random.default_rng(seed)
    N, R = 40, 4
    block = _block(rng, N, R)
    rows = rng.permutation(N)[:n_rows]
    idx = np.concatenate([rows, np.full(n_pad, N), N + rng.integers(1, 9, n_pad)])
    idx = idx.astype(np.int32)
    updates = _block(rng, len(idx), R)
    want = krt._scatter_node_rows(
        *(jnp.asarray(a) for a in block), jnp.asarray(idx),
        *(jnp.asarray(u) for u in updates))
    nodes = prt.DeviceNodeState(*(torch.from_numpy(a.copy()) for a in block))
    prt.scatter_node_rows_plain(nodes, torch.from_numpy(idx),
                                tuple(torch.from_numpy(u) for u in updates))
    for name, w in zip(prt.NODE_FIELDS, want):
        got = getattr(nodes, name).numpy()
        assert got.dtype == np.asarray(w).dtype, name
        assert np.array_equal(got, np.asarray(w)), name
    untouched = np.setdiff1d(np.arange(N), rows)
    assert np.array_equal(nodes.alloc.numpy()[untouched], block[0][untouched])


def test_scatter_kernel_takes_cuda_tensors_only():
    """No fallback inside the kernel's launch plan: a CPU block is refused
    (the block's ``ScatterPlan`` runs the plain version for a CPU block)."""
    nodes = prt.DeviceNodeState(*(torch.from_numpy(a) for a in
                                  _block(np.random.default_rng(3), 8, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ScatterLaunch(nodes)


# -------------------------------------------------------------- residency

def _encode_state(num_nodes=10, num_pods=6):
    cache = Cache()
    for i in range(num_nodes):
        cache.add_node(make_node(f"n{i}", cpu_milli=8000, memory=16 * 1024**3))
    pods = [make_pod(f"p{j}", cpu_milli=500, memory=512 * 1024**2)
            for j in range(num_pods)]
    return cache, pods


class _Pair:
    """One cluster held twice — kubetpu's Cache and a port copy — each
    with its own resident block, so neither consumes the other's
    ``pending_device_rows``."""

    def __init__(self, cache, pods):
        self.kcache, self.pcache = cache, port_cache(cache)
        self.pods, self.ppods = pods, [to_port(p) for p in pods]
        self.kres, self.pres = krt.ResidentNodeState(), prt.ResidentNodeState("cpu")
        self.ksnap = self.psnap = None
        self.kprev = self.pprev = None

    def apply(self, fn):
        fn(self.kcache, lambda x: x)
        fn(self.pcache, to_port)

    def encode(self):
        profile = KC.Profile()
        self.ksnap = self.kcache.update_snapshot(self.ksnap)
        self.psnap = self.pcache.update_snapshot(self.psnap)
        kb = krt.encode_batch(self.ksnap, self.pods, profile, prev_nt=self.kprev,
                              resident=self.kres)
        pb = prt.encode_batch(self.psnap, self.ppods, to_port(profile),
                              prev_nt=self.pprev, resident=self.pres, device="cpu")
        self.kprev, self.pprev = kb.node_tensors, pb.node_tensors
        # the ground truth: a full encode of the same cluster, no residency
        fresh = prt.encode_batch(self.pcache.update_snapshot(), self.ppods,
                                 to_port(profile), device="cpu")
        for name in prt.NODE_FIELDS:
            got = getattr(pb.device.nodes, name)
            assert torch.equal(got, getattr(fresh.device.nodes, name)), name
            assert np.array_equal(got.numpy(),
                                  np.asarray(getattr(kb.device.nodes, name))), name
        assert self.pres.last_upload_bytes == self.kres.last_upload_bytes
        assert pb.resident_bytes == kb.resident_bytes > 0
        assert pb.upload_bytes == kb.upload_bytes
        return kb, pb


def test_delta_refresh_equals_full_reencode():
    pair = _Pair(*_encode_state())
    pair.encode()
    block = pair.pres.nbytes

    def mutate(cache, conv):
        cache.add_pod(conv(make_pod("placed", cpu_milli=1500, memory=1024**3,
                                    node_name="n3")))
        cache.add_node(conv(make_node("n7", cpu_milli=2000, memory=4 * 1024**3)))

    pair.apply(mutate)
    _, pb = pair.encode()
    # the delta path: two dirty rows, padded to a bucket of 8
    assert 0 < pair.pres.last_upload_bytes < block
    assert pb.node_upload_bytes == pair.pres.last_upload_bytes


def test_clean_refresh_uploads_zero_bytes():
    pair = _Pair(*_encode_state())
    pair.encode()
    _, pb = pair.encode()
    assert pair.pres.last_upload_bytes == 0 == pb.node_upload_bytes
    assert pb.upload_bytes < prt.batch_nbytes(pb.device)


def _dense(cache, conv):
    for i in range(6):                  # 6 of 10 rows dirty: 2·6 ≥ 10
        cache.add_pod(conv(make_pod(f"d{i}", cpu_milli=100, memory=1024**2,
                                    node_name=f"n{i}")))


def _add(cache, conv):
    cache.add_node(conv(make_node("n10", cpu_milli=8000, memory=16 * 1024**3)))


def _delete(cache, conv):
    cache.remove_node("n4")


@pytest.mark.parametrize("event", [_dense, _add, _delete],
                         ids=["dense", "add", "delete"])
def test_refresh_after_node_events_as_kubetpu(event):
    """The dense-update rule (2·rows ≥ nodes → full upload), the in-place
    append on a node add (boundary rows scattered) and the incremental
    reshard on a node delete (rebuilt tensors diffed row-wise): each ships
    the bytes kubetpu's refresh ships and leaves the block a full encode
    would."""
    pair = _Pair(*_encode_state(num_nodes=10))
    pair.encode()
    block = pair.pres.nbytes
    pair.apply(event)
    pair.encode()
    if event is _dense:
        assert pair.pres.last_upload_bytes == block
    else:
        assert 0 < pair.pres.last_upload_bytes < block


def _dirty_one(cache, conv):
    cache.add_pod(conv(make_pod("one", cpu_milli=100, memory=1024**2, node_name="n2")))


def _nothing(cache, conv):
    pass


@pytest.mark.parametrize("event, copies", [
    (_dirty_one, 1), (_nothing, 1), (_dense, 2),
], ids=["delta", "clean", "dense"])
def test_host_to_device_copies_a_cycle(monkeypatch, event, copies):
    """A delta rides the pod leaves' copy: one host→device copy a cycle;
    only a full upload of the block (the first cycle, a dense update) is a
    copy of its own."""
    pair = _Pair(*_encode_state())
    calls = []
    real = prt.upload_packed

    def counted(arrays, device):
        calls.append(sorted(arrays))
        return real(arrays, device)

    monkeypatch.setattr(prt, "upload_packed", counted)
    profile = to_port(KC.Profile())
    snap = pair.pcache.update_snapshot()
    first = prt.encode_batch(snap, pair.ppods, profile, resident=pair.pres, device="cpu")
    assert len(calls) == 2
    pair.apply(event)
    calls.clear()
    prt.encode_batch(pair.pcache.update_snapshot(snap), pair.ppods, profile,
                     prev_nt=first.node_tensors, resident=pair.pres, device="cpu")
    assert len(calls) == copies
    assert ("delta.idx" in calls[-1]) == (event is _dirty_one)


def test_refresh_static_rejects_node_set_change():
    cache, pods = _encode_state(num_nodes=10)
    pcache = port_cache(cache)
    snap = pcache.update_snapshot()
    sb = prt.encode_batch_static(snap, [to_port(p) for p in pods], to_port(KC.Profile()))
    assert prt.refresh_static(sb, pcache.update_snapshot(snap)) is True
    # a node ADD fits the padding bucket: the encoder extends sb.nt in place
    pcache.add_node(to_port(make_node("n10", cpu_milli=8000, memory=16 * 1024**3)))
    assert prt.refresh_static(sb, pcache.update_snapshot(snap)) is False


# ---------------------------------------------------------------- pipeline

def _parity_run(factory, pipeline, events=None, num_pods=40, max_batch=8):
    """The reference's parity case: 12 nodes over three zones, a bound
    color=blue seed pod, ``num_pods`` pods of ``factory`` in sched-0, on
    kubetpu's and the port's scheduler. Returns both bound maps and the
    port's scheduler."""
    maps = []
    for s, client in scheduler_pair(max_batch=max_batch, pipeline=pipeline):
        conv = to_port if "torch" in type(s).__module__ else (lambda x: x)
        for i in range(12):
            s.on_node_add(conv(KW.node_default(i, zones=("zone-a", "zone-b", "zone-c"))))
        s.on_pod_add(conv(make_pod(
            "seed-0", namespace="sched-0", labels={"color": "blue"},
            cpu_milli=100, memory=100 * 1024**2, node_name="scheduler-perf-0")))
        for j in range(num_pods):
            s.on_pod_add(conv(factory(f"p-{j}", "sched-0")))
        ev = None if events is None else {k: (lambda f: lambda sc: f(sc, conv))(f)
                                          for k, f in events.items()}
        maps.append(drive(s, client, max_batch=max_batch, events=ev))
        port = s
    return maps[0], maps[1], port


@pytest.mark.parametrize("factory", [
    KW.pod_default, KW.pod_with_topology_spreading, KW.pod_with_pod_affinity,
    # the spread score and required anti-affinity read the counts that the
    # previous batch's assumes moved: an affinity or spread encode done in
    # stage 1 (before those assumes land) binds differently
    KW.pod_with_preferred_topology_spreading, KW.pod_with_pod_anti_affinity,
], ids=["basic", "spread", "interpod-affinity", "preferred-spread",
        "anti-affinity"])
def test_pipelined_matches_serial_pod_for_pod(factory):
    k_serial, p_serial, _ = _parity_run(factory, pipeline=False)
    k_pipe, p_pipe, ps = _parity_run(factory, pipeline=True)
    assert p_pipe == p_serial == k_pipe == k_serial
    assert len(p_serial) > 1
    assert any(c.pipelined for c in ps.metrics.cycle_timings)


def _bigger_node(s, conv):
    """A node update under the in-flight cycle: scheduler-perf-3 grows."""
    old = KW.node_default(3, ("zone-a", "zone-b", "zone-c"))
    new = make_node("scheduler-perf-3", cpu_milli=64000, memory=512 * 1024**3,
                    pods=500, labels=dict(old.labels))
    s.on_node_update(conv(old), conv(new))


def test_mid_pipeline_node_update_replays_and_keeps_parity():
    k_serial, p_serial, _ = _parity_run(KW.pod_default, False, events={2: _bigger_node})
    k_pipe, p_pipe, ps = _parity_run(KW.pod_default, True, events={2: _bigger_node})
    assert p_pipe == p_serial == k_pipe == k_serial
    assert ps.metrics.pipeline_replays >= 1
    # the update took effect: the grown node absorbed the later pods
    assert list(p_serial.values()).count("scheduler-perf-3") > 4


def test_bind_confirmations_do_not_replay():
    """Steady-state informer traffic — bind confirmations of the
    scheduler's own assumed pods, identical accounting — never replays."""
    _, (s, client) = scheduler_pair(max_batch=4, pipeline=True)
    for i in range(6):
        s.on_node_add(to_port(KW.node_default(i)))
    for j in range(24):
        s.on_pod_add(to_port(make_pod(f"p-{j}", cpu_milli=100,
                                      memory=100 * 1024**2, creation_index=j)))
    assert len(drive(s, client, max_batch=4)) == 24
    assert s.metrics.pipeline_replays == 0
    assert sum(c.pipelined for c in s.metrics.cycle_timings) >= 4


@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
def test_defaults_ship_only_dirty_rows(pipeline):
    """``run_workload`` on its defaults (encode cache on, resident block):
    with many more nodes than a batch binds, the measured cycles' node
    uploads are deltas, far below the resident block."""
    r = run_workload("SchedulingBasic",
                     KW.Workload("smoke", {"initNodes": 120, "initPods": 20,
                                           "measurePods": 96}),
                     device="cpu", max_batch=16, pipeline=pipeline)
    assert r.scheduled == 96
    assert r.resident_bytes > 0
    assert 0 < r.node_upload_bytes_per_cycle < r.resident_bytes / 2
    assert r.encode_cache_hit_rate is not None and r.encode_cache_hit_rate > 0.9
    assert r.pipeline_replays == 0
    # the node encode's sub-spans: stage 1's own in both cycles, the
    # staleness refreshes only in the pipelined one
    assert 0 < r.cycle_ms["nodes"] < r.cycle_ms["pre_encode"]
    assert (r.cycle_ms["refresh"] > 0) == pipeline
    assert r.gc_s >= 0 and r.gc_full_collections >= 0


def test_gc_clock_counts_collections():
    """The runner's garbage-collector clock counts the full collections
    and their time while entered, and nothing after."""
    clock = _GcClock()
    with clock:
        gc.collect()
        gc.collect(0)
    assert clock.full == 1 and clock.seconds > 0
    seconds = clock.seconds
    gc.collect()
    assert clock.full == 1 and clock.seconds == seconds
