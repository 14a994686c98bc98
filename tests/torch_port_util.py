"""Helpers shared by the ``test_torch_*`` parity tests: carry kubetpu's
cluster objects and device batches across to the PyTorch port.

The port keeps its own copies of the host types (``kubetpu_torch.api``), so
a kubetpu object is rebuilt field for field as the port's same-named class.
Device batches cross as numpy leaves (``jax.device_get``), keyed by the
reference's field names.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib

import jax
import torch

import kubetpu  # noqa: F401  (x64 on before any kernel runs)
from kubetpu.api import types as kt
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.state.snapshot import Cache

from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.state.snapshot import Cache as PortCache


def to_port(obj):
    """Rebuild a kubetpu host object (dataclass / enum / container tree) as
    the port's same-named class."""
    if isinstance(obj, enum.Enum):
        cls = _port_class(type(obj))
        return cls[obj.name] if cls is not type(obj) else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _port_class(type(obj))
        kw = {}
        late = {}
        for f in dataclasses.fields(obj):
            v = to_port(getattr(obj, f.name))
            (kw if f.init else late)[f.name] = v
        new = cls(**kw)
        for k, v in late.items():
            object.__setattr__(new, k, v)
        return new
    if isinstance(obj, tuple):
        return tuple(to_port(v) for v in obj)
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    if isinstance(obj, frozenset):
        return frozenset(to_port(v) for v in obj)
    if isinstance(obj, dict):
        return {to_port(k): to_port(v) for k, v in obj.items()}
    return obj


def _port_class(cls):
    mod = cls.__module__
    if not mod.startswith("kubetpu."):
        return cls
    port_mod = importlib.import_module("kubetpu_torch." + mod[len("kubetpu."):])
    return getattr(port_mod, cls.__qualname__)


def port_cache(cache) -> PortCache:
    """The port's Cache holding the same nodes (in order), pods, services,
    volume listers (PVs, PVCs, storage classes) and DRA objects (device
    classes, resource slices, resource claims, in insertion order)."""
    pc = PortCache()
    for name in cache._node_order:
        pc.add_node(to_port(cache._nodes[name].node))
    for pod in cache._pods.values():
        pc.add_pod(to_port(pod))
    for svc in cache._services.values():
        pc.add_service(to_port(svc))
    for pv in cache._pvs.values():
        pc.add_pv(to_port(pv))
    for pvc in cache._pvcs.values():
        pc.add_pvc(to_port(pvc))
    for sc in cache._storage_classes.values():
        pc.add_storage_class(to_port(sc))
    for dc in cache.dra.device_classes.values():
        pc.dra.add_class(to_port(dc))
    for sl in cache.dra.slices.values():
        pc.dra.add_slice(to_port(sl))
    for claim in cache.dra.claims.values():
        pc.dra.add_claim(to_port(claim))
    return pc


def jax_leaves(b: "krt.DeviceBatch") -> dict:
    """numpy leaves of a kubetpu DeviceBatch keyed by field name."""
    host = jax.device_get(b)
    out = {f.name: getattr(host.nodes, f.name)
           for f in dataclasses.fields(host.nodes)}
    for f in dataclasses.fields(host):
        if f.name != "nodes":
            out[f.name] = getattr(host, f.name)
    return out


def port_batch_from_jax(b: "krt.DeviceBatch", device="cpu") -> "prt.DeviceBatch":
    return prt.device_batch_from_numpy(jax_leaves(b), device)


def port_params(params: "krt.ScoreParams") -> "prt.ScoreParams":
    return prt.score_params_from_dict(dataclasses.asdict(params))


def images_cluster(rng, num_nodes=30, num_pending=20):
    """Nodes carrying images and zone labels; pods with images, preferred
    node affinity and PreferNoSchedule tolerations."""
    cache = Cache()
    imgs = [f"img-{i}" for i in range(5)]
    for i in range(num_nodes):
        node_images = {
            im: kt.ImageState(size_bytes=int(rng.integers(10, 900)) * 1024**2,
                              num_nodes=int(rng.integers(1, num_nodes)))
            for im in imgs if rng.random() < 0.4
        }
        taints = ()
        if rng.random() < 0.3:
            taints = (kt.Taint(key="k", value="v",
                               effect=kt.TaintEffect.PREFER_NO_SCHEDULE),)
        cache.add_node(make_node(
            f"n-{i}", cpu_milli=int(rng.integers(1000, 8000)),
            memory=int(rng.integers(1, 16)) * 1024**3,
            labels={"zone": f"z{i % 3}"}, taints=taints, images=node_images,
        ))
    pending = []
    for j in range(num_pending):
        kw = {}
        if rng.random() < 0.5:
            kw["images"] = list(rng.choice(imgs, size=2, replace=False))
        if rng.random() < 0.5:
            kw["affinity"] = kt.Affinity(node_affinity=kt.NodeAffinity(preferred=(
                kt.PreferredSchedulingTerm(int(rng.integers(1, 100)), kt.NodeSelectorTerm(
                    (kt.Requirement("zone", kt.Operator.IN, (f"z{j % 3}",)),))),
            )))
        pending.append(make_pod(f"p-{j}", cpu_milli=int(rng.integers(0, 2000)),
                                memory=int(rng.integers(0, 4)) * 1024**3,
                                creation_index=j, **kw))
    return cache, pending


def basic_cluster(num_nodes=100, num_bound=60, num_pending=40):
    cache = Cache()
    nodes = [KW.node_default(i) for i in range(num_nodes)]
    for n in nodes:
        cache.add_node(n)
    for j in range(num_bound):
        cache.add_pod(KW.pod_default(f"init-{j}", "namespace-0").with_node(
            nodes[j % num_nodes].name))
    pending = [KW.pod_default(f"m-{j}", "namespace-1") for j in range(num_pending)]
    return cache, pending


def encoded_pair(cache, pending, profile):
    """kubetpu's encoded batch and params, and the port's batch carried
    across from it (``device_batch_from_numpy`` on CPU) with its params."""
    kb = krt.encode_batch(cache.update_snapshot(), pending, profile)
    kp = krt.score_params(profile, kb.resource_names)
    return kb.device, kp, port_batch_from_jax(kb.device), port_params(kp)


def _assert_leaf_equal(x, y, name):
    assert (x is None) == (y is None), name
    if x is None:
        return
    assert x.dtype == y.dtype, name
    assert tuple(x.shape) == tuple(y.shape), name
    assert torch.equal(x.cpu(), y.cpu()), name


def assert_batches_equal(a: "prt.DeviceBatch", b: "prt.DeviceBatch") -> None:
    """Two port DeviceBatches agree leaf for leaf: presence, dtype, shape
    and value, the affinity and spread leaves' tensors and flags included
    (carry a kubetpu batch across with ``port_batch_from_jax`` first)."""
    la, lb = prt.batch_leaves(a), prt.batch_leaves(b)
    assert set(la) == set(lb)
    for name, x in la.items():
        y = lb[name]
        if name not in prt.NESTED:
            _assert_leaf_equal(x, y, name)
            continue
        assert (x is None) == (y is None), name
        if x is None:
            continue
        _, fields, flags = prt.NESTED[name]
        for f in fields:
            _assert_leaf_equal(getattr(x, f), getattr(y, f), f"{name}.{f}")
        for f in flags:
            assert getattr(x, f) == getattr(y, f), f"{name}.{f}"


class FakeClock:
    """A clock the test advances by hand (backoff and flush timers)."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def scheduler_pair(max_batch=8, profile=None, **kw):
    """kubetpu's Scheduler (greedy, synchronous binds, no flight recorder)
    and the port's on the CPU, each with a bind-recording client that
    echoes binds back through the informer seam (``client.deliver()``) and
    a hand-driven clock. ``kw`` (``pipeline``, ``encode_cache``) goes to
    both. Returns ``((ks, kc), (ps, pc))``."""
    from kubetpu.framework import config as KC
    from kubetpu.perf.runner import _Client as KClient
    from kubetpu.sched.scheduler import Scheduler as KScheduler
    from kubetpu_torch.perf.runner import _Client as PClient
    from kubetpu_torch.sched import Scheduler as PScheduler

    profile = profile or KC.Profile()
    kc, pc = KClient(), PClient()
    ks = KScheduler(kc, profile=profile, max_batch=max_batch, engine="greedy",
                    dispatcher_workers=0, flight_recorder=False,
                    clock=FakeClock(), **kw)
    ps = PScheduler(pc, profile=to_port(profile), max_batch=max_batch,
                    device="cpu", clock=FakeClock(), **kw)
    kc.sched, pc.sched = ks, ps
    return (ks, kc), (ps, pc)


def drive(sched, client, max_batch=None, events=None, max_calls=200) -> dict:
    """Run ``schedule_batch`` until three idle calls in a row, delivering
    bind confirmations between calls; ``events`` ({call index: fn(sched)})
    fire before that call — with the pipeline on, while a cycle is in
    flight. A trailing in-flight cycle is completed. Returns the bound map
    (pod name → node)."""
    calls = idle = 0
    while idle < 3 and calls < max_calls:
        if events and calls in events:
            events[calls](sched)
        res = sched.schedule_batch(max_batch)
        client.deliver()
        calls += 1
        busy = res["scheduled"] or res["unschedulable"]
        idle = 0 if busy else idle + 1
    if sched._inflight is not None:
        sched._complete_inflight()
        client.deliver()
    return dict(client.bound)


class RecordingClient:
    """A client for both schedulers of a pair: records binds (pod key →
    node), the claim-status writes of DynamicResources' PreBind and the PVC
    binds of VolumeBinding's PreBind; the first bind of each key in
    ``fail_binds_for`` raises."""

    def __init__(self, fail_binds_for=()):
        self.bound = {}
        self.fail_binds_for = set(fail_binds_for)
        self.claim_status = []
        self.pvc_binds = []

    def bind(self, pod, node_name):
        key = f"{pod.namespace}/{pod.name}"
        if key in self.fail_binds_for:
            self.fail_binds_for.discard(key)
            raise RuntimeError(f"bind conflict for {key}")
        self.bound[key] = node_name

    def patch_status(self, pod, reason, message=""):
        pass

    def update_claim_status(self, claim):
        self.claim_status.append((claim.key, claim.allocation, claim.reserved_for))

    def bind_pvc(self, pvc, pv_name):
        self.pvc_binds.append((pvc.key, pv_name))


class Side:
    """One scheduler of a pair: kubetpu's (``dispatcher_workers=0``) or the
    port's on the CPU, each with its own ``RecordingClient`` and stepped
    clock. ``T`` / ``W`` are its types and wrappers modules; ``profile`` is
    a kubetpu Profile (carried across for the port)."""

    def __init__(self, port, profile, fail_binds_for=(), **kw):
        from kubetpu.api import types as KT
        from kubetpu.api import wrappers as KWR
        from kubetpu.sched.scheduler import Scheduler as KScheduler
        from kubetpu_torch.api import types as PT
        from kubetpu_torch.api import wrappers as PWR
        from kubetpu_torch.sched import Scheduler as PScheduler

        self.port = port
        self.T = PT if port else KT
        self.W = PWR if port else KWR
        self.c = RecordingClient(fail_binds_for)
        self.clock = FakeClock()
        if port:
            self.s = PScheduler(self.c, profile=to_port(profile), device="cpu",
                                clock=self.clock, **kw)
        else:
            self.s = KScheduler(client=self.c, profile=profile,
                                dispatcher_workers=0, clock=self.clock, **kw)

    def _drain(self):
        if not self.port:
            self.s.dispatcher.sync()
            self.s._drain_bind_completions()

    def run(self):
        n = self.s.run_until_idle()
        self._drain()
        return n

    def step(self):
        n = self.s.schedule_batch()["scheduled"]
        self._drain()
        return n

    def state(self):
        """Everything the binding cycle writes, in the port's types: the
        bound map, each claim's allocation and reservations, the
        claim-status writes, the allocated devices by node, each PVC's
        volume, each PV's claim, and the PVC binds."""
        cp = (lambda v: v) if self.port else to_port
        cache = self.s.cache
        claims = {k: (cp(c.allocation), tuple(c.reserved_for))
                  for k, c in sorted(cache.dra.claims.items())}
        status = [(k, cp(a), tuple(r)) for k, a, r in self.c.claim_status]
        used = sorted((node, tuple(sorted(keys)))
                      for node, keys in cache.dra.allocated_devices.items())
        pvcs = {k: c.volume_name for k, c in sorted(cache._pvcs.items())}
        pvs = {k: v.claim_ref for k, v in sorted(cache._pvs.items())}
        return dict(bound=dict(self.c.bound), claims=claims, status=status,
                    used=used, pvcs=pvcs, pvs=pvs, pvc_binds=list(self.c.pvc_binds))


def both(scenario, **kw):
    """Run ``scenario(side)`` on kubetpu's side and on the port's; its
    return values and the two ``Side.state()`` must be equal. Returns the
    port's side and result."""
    out = []
    for port in (False, True):
        side = Side(port, **kw)
        res = scenario(side)
        out.append((side, res, side.state()))
    (_, kres, kstate), (pside, pres, pstate) = out
    assert pres == kres
    for key in kstate:
        assert pstate[key] == kstate[key], key
    return pside, pres
