"""The port's flight recorder equals kubetpu's.

- B10's plain versions: ``explain_summary_plain`` and
  ``filter_component_masks_plain`` against kubetpu's ``_explain_kernel`` and
  ``_explain_masks_kernel`` on seeded batches — equal (``SchedulingBasic``
  nodes, every score tied), saturated (rows with fewer than three feasible
  nodes, some with none), node-affinity and taint preferences, spread,
  inter-pod affinity, nominations and extender leaves — with assignment
  vectors that hold -1 (``win`` then reads node 0): every array equal,
  absent components None on both sides. The packed rows of
  ``filter_component_masks_rows_plain`` (all, some, repeated, many, one
  of each pod class), unpacked, equal kubetpu's masks at those rows, and
  the kernel's host plan (``kernels.mask_plan``) writes every row once
  through a pod of its class.
- The records: the port's ``Scheduler(device="cpu")`` and kubetpu's
  ``Scheduler(dispatcher_workers=0)`` on a run with unschedulable pods,
  requeues, a preemption and a bind error give the same records (the
  timing fields left out): statuses, breakdowns, rejection counts and
  examples, top nodes, win margins, requeue hops, nominations, victims;
  and cycles whose unschedulable pods are rejected by two or three
  plugins name the same example nodes.
- The pipelined cycle's records equal the serial cycle's, and
  ``flight_recorder=False`` leaves the decisions unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.sched import Scheduler as KScheduler
from kubetpu.sched import flightrecorder as KFR
from kubetpu.state.snapshot import Cache

from kubetpu_torch.sched import Scheduler as PScheduler
from kubetpu_torch.sched import flightrecorder as PFR

from .test_scheduler import FakeClient
from .test_scheduler import FakeClock as KFakeClock
from .test_torch_extender import extender_pair
from .test_torch_nominations import nominated_cluster
from .test_torch_spread import _pair as spread_pair
from .torch_port_util import (
    FakeClock,
    images_cluster,
    port_batch_from_jax,
    port_params,
    to_port,
)

# ------------------------------------------------------ B10, the plain twins


def _equal_nodes(rng):
    """SchedulingBasic nodes and pods: every node scores the same."""
    cache = Cache()
    for i in range(30):
        cache.add_node(KW.node_default(i))
    return cache, [KW.pod_default(f"m-{j}", "ns") for j in range(20)], KC.Profile()


def _saturated(rng):
    """Pods whose requests fit on 0, 1, 2 or many of the nodes."""
    cache = Cache()
    for i in range(12):
        cache.add_node(make_node(f"n{i}", cpu_milli=1000 * (i + 1),
                                 memory=(i + 1) * 2**30, pods=4))
    pending = [make_pod(f"p{j}", cpu_milli=int(rng.choice([500, 9500, 10500, 11500, 20000])),
                        memory=2**28, creation_index=j) for j in range(20)]
    return cache, pending, KC.Profile()


def _images(rng):
    cache, pending = images_cluster(rng)
    return cache, pending, KC.Profile()


def _nominations(rng):
    cache, pending, nom = nominated_cluster(int(rng.integers(0, 100)))
    return cache, pending, KC.Profile(), nom


CLUSTERS = {"equal": _equal_nodes, "saturated": _saturated, "images": _images,
            "nominations": _nominations}


def _encoded(case, seed):
    rng = np.random.default_rng(seed)
    if case.startswith("spread"):
        kb, kp, pb, pp = spread_pair("mixed", seed, "spread")
        return kb, kp, pb, pp
    if case.startswith("extender"):
        return extender_pair(case.split("-", 1)[1], seed)
    out = CLUSTERS[case](rng)
    cache, pending, profile = out[:3]
    nominated = out[3].entries() if len(out) > 3 else ()
    kb = krt.encode_batch(cache.update_snapshot(), pending, profile,
                          nominated=nominated)
    kp = krt.score_params(profile, kb.resource_names)
    return kb.device, kp, port_batch_from_jax(kb.device), port_params(kp)


CASES = sorted(CLUSTERS) + ["spread", "extender-affinity", "extender-images",
                            "extender-spread"]


def _idx(seed, P, N):
    """A seeded assignment vector: node indices, with -1 (unschedulable
    and padded pods) mixed in."""
    rng = np.random.default_rng(seed + 1000)
    idx = rng.integers(0, N, P).astype(np.int32)
    idx[rng.random(P) < 0.3] = -1
    return idx


def _eq(got, want):
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape
    assert np.array_equal(g, want)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", CASES)
def test_explain_summary_plain_equals_reference(case, seed):
    kdev, kp, pdev, pp = _encoded(case, seed)
    P, N = pdev.requests.shape[0], pdev.alloc.shape[0]
    idx = _idx(seed, P, N)
    kf, krej, kv, ki, kw = KFR._explain_kernel(kdev, kp, jnp.asarray(idx))
    pf, prej, pv, pi, pw = PFR.explain_summary_plain(pdev, pp, idx)
    _eq(pf, kf)
    assert len(prej) == len(krej) == 5
    for got, want in zip(prej, krej):
        assert (got is None) == (want is None)
        if got is not None:
            _eq(got, want)
    _eq(pv, kv)
    _eq(pi, ki)
    _eq(pw, kw)


def test_explain_summary_covers_its_edges():
    """The saturated case holds rows with fewer than three feasible nodes
    (top-3 repeats node 0 at -2^62) and none (top_idx all 0); the equal
    case ties every score (first index wins)."""
    kdev, kp, pdev, pp = _encoded("saturated", 0)
    f, _, v, i, _ = PFR.explain_summary_plain(pdev, pp, _idx(0, 32, 16))
    f = f.numpy()
    assert (f == 0).any() and ((f > 0) & (f < 3)).any() and (f >= 3).any()
    row = int(np.flatnonzero(f == 1)[0])
    assert int(v[row, 1]) == PFR._NEG and int(i[row, 1]) == 0
    _, _, _, i, _ = PFR.explain_summary_plain(*_encoded("equal", 0)[2:], np.zeros(32, np.int32))
    assert i[0].tolist() == [0, 1, 2]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", CASES)
def test_component_masks_plain_equal_reference(case, seed):
    kdev, kp, pdev, pp = _encoded(case, seed)
    want = KFR._explain_masks_kernel(kdev, kp)
    got = PFR.filter_component_masks_plain(pdev, pp)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _eq(g, w)


ROW_KINDS = ("all", "some", "repeated", "many", "classes")


def _rows(kind, pdev, seed):
    """Host rows of a masks call: all (None), a seeded subset, a subset
    with rows repeated, every pod three times over in a seeded order (more
    rows than the plan's small path takes), or one pod of each pod class
    (each class's representative)."""
    from kubetpu_torch.framework import runtime as prt

    P = pdev.requests.shape[0]
    rng = np.random.default_rng(seed + 77)
    if kind == "all":
        return None
    if kind == "some":
        return sorted(rng.choice(P, size=max(1, P // 3), replace=False).tolist())
    if kind == "repeated":
        some = rng.choice(P, size=max(1, P // 4), replace=False).tolist()
        return some + some[::2] + [some[0]]
    if kind == "many":
        return rng.permutation(np.tile(np.arange(P), 3)).tolist()
    classes = prt.pod_classes(pdev)
    return list(range(P)) if classes is None else classes.host_reps().tolist()


@pytest.mark.parametrize("kind", ROW_KINDS)
@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", CASES)
def test_component_masks_rows_plain_equal_reference(case, seed, kind):
    """The packed rows of the masks kernel's plain version, unpacked, equal
    kubetpu's masks at those rows; an absent component's bit is 0."""
    kdev, kp, pdev, pp = _encoded(case, seed)
    want = KFR._explain_masks_kernel(kdev, kp)
    rows = _rows(kind, pdev, seed)
    bits, present = PFR.filter_component_masks_rows_plain(pdev, pp, rows)
    P, N = pdev.requests.shape[0], pdev.alloc.shape[0]
    sel = np.arange(P) if rows is None else np.asarray(rows)
    assert bits.dtype == torch.uint8 and tuple(bits.shape) == (len(sel), N)
    bits = bits.numpy()
    assert present == tuple(w is not None for w in want)
    for c, w in enumerate(want):
        got = ((bits >> c) & 1).astype(bool)
        if w is None:
            assert not got.any()
        else:
            assert np.array_equal(got, np.asarray(w)[sel])
    assert not (bits >> 5).any()


@pytest.mark.parametrize("kind", ROW_KINDS)
@pytest.mark.parametrize("case", CASES)
def test_mask_plan_rows_through_their_class(case, kind):
    """The kernel's host plan (``kernels.mask_plan``): every requested row
    written once, by a class whose representative's packed row equals the
    row's own; a class a pod where the batch has none."""
    from kubetpu_torch import kernels
    from kubetpu_torch.framework import runtime as prt

    _, _, pdev, pp = _encoded(case, 0)
    P = pdev.requests.shape[0]
    rows = _rows(kind, pdev, 0)
    sel = np.arange(P) if rows is None else np.asarray(rows)
    classes = prt.pod_classes(pdev)
    plan, C, U, first = kernels.mask_plan(classes, rows, P)
    assert U == len(sel)
    full = PFR.filter_component_masks_rows_plain(pdev, pp)[0].numpy()
    if plan is None:
        assert C == U and np.array_equal(sel, first + np.arange(U))
        assert U == 1 or classes is None or not classes.shared
        return
    assert plan.dtype == np.int32 and len(plan) == 2 * C + 1 + U
    reps, start, pos = plan[:C], plan[C:2 * C + 1], plan[2 * C + 1:]
    assert start[0] == 0 and start[-1] == U and (np.diff(start) > 0).all()
    assert sorted(pos.tolist()) == list(range(U))
    out = np.zeros((U, full.shape[1]), dtype=np.uint8)
    for j in range(C):
        for u in pos[start[j]:start[j + 1]]:
            if classes is not None and classes.shared:
                assert classes.class_of[sel[u]] == classes.class_of[reps[j]]
            else:
                assert sel[u] == reps[j]
            out[u] = full[reps[j]]
    assert np.array_equal(out, full[sel])
    if kind == "classes" and classes is not None and classes.shared:
        assert C == classes.count


def test_explain_dispatch_on_the_cpu_is_the_plain_version():
    _, _, pdev, pp = _encoded("images", 0)
    idx = _idx(0, pdev.requests.shape[0], pdev.alloc.shape[0])
    for got, want in zip(PFR._explain_kernel(pdev, pp, idx),
                         PFR.explain_summary_plain(pdev, pp, idx)):
        if isinstance(got, tuple):
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                assert g is None or bool((g == w).all())
        else:
            assert bool((got == want).all())


# ---------------------------------------------------------------- records

TIMING = ("encode_s", "kernel_s", "queue_wait_s", "stages_ms")


class _Client(FakeClient):
    def __init__(self, fail_binds_for=()):
        super().__init__(fail_binds_for)
        self.deleted = []
        self.nominated = []

    def delete_pod(self, pod, reason=""):
        self.deleted.append(pod.name)

    def nominate(self, pod, node_name):
        self.nominated.append((pod.name, node_name))


def _records(fr):
    return [{k: v for k, v in r.items() if k not in TIMING}
            for r in fr.records_json(limit=10_000)["records"]]


def _cluster_ops(add_node, add_pod):
    """Two full nodes of low-priority pods, a small node that takes two of
    the six small pods, a pod too big for any node, and one high-priority
    pod that fits nowhere without preempting."""
    for i in range(2):
        add_node(make_node(f"full-{i}", cpu_milli=1000, memory=4 * 2**30))
        add_pod(make_pod(f"low-{i}", cpu_milli=900, priority=0,
                         node_name=f"full-{i}", creation_index=i))
    add_node(make_node("small", cpu_milli=800, memory=8 * 2**30, pods=5))
    for j in range(6):
        add_pod(make_pod(f"p{j}", cpu_milli=400, creation_index=10 + j))
    add_pod(make_pod("huge", cpu_milli=50_000, creation_index=30))
    add_pod(make_pod("high", cpu_milli=900, priority=100, creation_index=40))


def _drive_k(profile, cycles, clock_step):
    client = _Client(fail_binds_for=("default/p1",))
    clock = KFakeClock()
    s = KScheduler(client, profile=profile, dispatcher_workers=0,
                   clock=clock, max_batch=4)
    s.enable_preemption()
    _cluster_ops(s.on_node_add, s.on_pod_add)
    for _ in range(cycles):
        s.schedule_batch()
        s.dispatcher.sync()
        s._drain_bind_completions()
        clock.tick(clock_step)
    return s, client


def _drive_p(profile, cycles, clock_step, fail=("default/p1",), **kw):
    client = _Client(fail_binds_for=fail)
    clock = FakeClock()
    s = PScheduler(client, profile=to_port(profile), device="cpu", clock=clock,
                   max_batch=4, **kw)
    s.enable_preemption()
    _cluster_ops(lambda n: s.on_node_add(to_port(n)),
                 lambda p: s.on_pod_add(to_port(p)))
    for _ in range(cycles):
        s.schedule_batch()
        clock.tick(clock_step)
    if s._inflight is not None:
        s._complete_inflight()
    return s, client


@pytest.mark.parametrize("profile", [KC.Profile(), KC.minimal_profile()],
                         ids=["default", "minimal"])
def test_records_equal_reference(profile):
    ks, kc = _drive_k(profile, cycles=8, clock_step=15)
    ps, pc = _drive_p(profile, cycles=8, clock_step=15)
    assert pc.bound == kc.bound
    assert pc.deleted == kc.deleted and pc.nominated == kc.nominated
    want, got = _records(ks.flight_recorder), _records(ps.flight_recorder)
    assert got == want
    statuses = {r["status"] for r in got}
    assert {"bound", "unschedulable", "bind_error"} <= statuses
    assert any("preemption_victims" in r for r in got)
    assert any("rejected_examples" in r for r in got)
    assert any(r.get("requeue") for r in got)
    assert ps.flight_recorder.breakdown_failures == 0
    assert ps.flight_recorder.explains >= 1


def _rejections_ops(add_node, add_pod):
    """Nodes each pod class is rejected on by another plugin: tainted ones
    (the static group), small ones (NodeResourcesFit) and ones whose pod
    holds host port 8080 (NodePorts); pods that fit nowhere for two or
    three of those reasons at once, four to a cycle."""
    from kubetpu.api import types as kt

    for i in range(3):
        add_node(make_node(f"tainted-{i}", cpu_milli=8000,
                           taints=(kt.Taint("dedicated", "x"),)))
        add_node(make_node(f"small-{i}", cpu_milli=500))
        add_node(make_node(f"port-{i}", cpu_milli=8000))
        add_pod(make_pod(f"holder-{i}", cpu_milli=100, host_ports=(8080,),
                         node_name=f"port-{i}", creation_index=i))
    for j in range(3):
        add_pod(make_pod(f"web-{j}", cpu_milli=3000, host_ports=(8080,),
                         creation_index=10 + j))
    add_pod(make_pod("huge", cpu_milli=50_000, creation_index=20))
    add_pod(make_pod("sel", cpu_milli=100, node_selector={"zone": "nowhere"},
                     creation_index=21))
    add_pod(make_pod("ok", cpu_milli=100, creation_index=22))


def test_rejected_examples_equal_reference():
    """Cycles with several unschedulable pods, each rejected by two or
    three plugins: the records' rejection counts and example nodes (read
    from the packed masks of those pods' rows) equal kubetpu's."""
    kclient, pclient = _Client(), _Client()
    ks = KScheduler(kclient, profile=KC.Profile(), dispatcher_workers=0,
                    clock=KFakeClock(), max_batch=4)
    ps = PScheduler(pclient, profile=to_port(KC.Profile()), device="cpu",
                    clock=FakeClock(), max_batch=4)
    _rejections_ops(ks.on_node_add, ks.on_pod_add)
    _rejections_ops(lambda n: ps.on_node_add(to_port(n)),
                    lambda p: ps.on_pod_add(to_port(p)))
    for _ in range(3):
        ks.schedule_batch()
        ks.dispatcher.sync()
        ks._drain_bind_completions()
        ps.schedule_batch()
    if ps._inflight is not None:
        ps._complete_inflight()
    assert pclient.bound == kclient.bound
    want, got = _records(ks.flight_recorder), _records(ps.flight_recorder)
    assert got == want
    examples = [r["rejected_examples"] for r in got if "rejected_examples" in r]
    assert len(examples) >= 4
    assert max(len(e) for e in examples) >= 3
    assert all(e for ex in examples for e in ex.values())


def test_pipelined_records_equal_serial():
    """Without a bind error (whose requeue lands a cycle later when the next
    batch was popped before it), the pipelined cycle decides as the serial
    one and records the same."""
    profile = KC.Profile()
    serial, sc = _drive_p(profile, cycles=8, clock_step=15, fail=())
    piped, pc = _drive_p(profile, cycles=8, clock_step=15, fail=(), pipeline=True)
    assert pc.bound == sc.bound
    assert _records(piped.flight_recorder) == _records(serial.flight_recorder)


def test_recorder_off_leaves_decisions_unchanged():
    on, con = _drive_p(KC.Profile(), cycles=6, clock_step=15)
    off, coff = _drive_p(KC.Profile(), cycles=6, clock_step=15,
                         flight_recorder=False)
    assert off.flight_recorder is None
    assert coff.bound == con.bound and coff.nominated == con.nominated
    assert all(t.recorder_s == 0.0 for t in off.metrics.cycle_timings)


def test_lookup_resolves_and_renders():
    s, _ = _drive_p(KC.Profile(), cycles=6, clock_step=15)
    rec = s.flight_recorder.lookup("default/p0")
    assert rec["status"] == "bound" and rec["view"] == "cycle-start"
    assert rec["win"]["node"] == rec["node"]
    assert set(rec["stages_ms"]) >= {"informer", "queue_wait", "encode",
                                     "kernel", "bind_rtt", "e2e"}
    assert s.flight_recorder.lookup("default/nobody") is None


def test_explain_errors_propagate(monkeypatch):
    """Unlike the reference (which counts and swallows them), an error of
    the explain reaches the caller, and the cycle's pods are requeued."""

    def broken(*a, **k):
        raise RuntimeError("explain launch refused")

    monkeypatch.setattr(PFR, "_explain_kernel", broken)
    client = _Client()
    s = PScheduler(client, profile=to_port(KC.minimal_profile()), device="cpu",
                   clock=FakeClock())
    s.on_node_add(to_port(make_node("n0", cpu_milli=4000)))
    s.on_pod_add(to_port(make_pod("p", cpu_milli=100)))
    with pytest.raises(RuntimeError, match="explain launch refused"):
        s.schedule_batch()
    assert client.bound == {}
    assert s.metrics.errors == 1


def test_device_profile_writes_a_chrome_trace(tmp_path):
    from kubetpu_torch.tracing import device_profile

    _, _, pdev, pp = _encoded("images", 0)
    with device_profile(str(tmp_path)) as prof:
        PFR.explain_summary_plain(pdev, pp, np.zeros(pdev.requests.shape[0], np.int32))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
