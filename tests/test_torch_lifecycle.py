"""The port's lifecycle runner and config validation against kubetpu's.

The scenarios of ``tests/test_lifecycle.py`` run through both schedulers
(kubetpu's with ``dispatcher_workers=0``, the port's on the CPU), each with
a recording test plugin registered under its own ``framework.lifecycle``:
the full Reserve → Permit → PreBind → PostBind order, a Reserve rejection
(Unreserve, the assume rolled back, the pod requeued), Permit's wait with
allow, reject and timeout, a waiting pod deleted, a failed bind and a
failed PreBind (Unreserve, requeue, retry). Both must record the same
plugin events, bind the same pods, and agree on the queue, the waiting
pods and the cache. The port's ``Registry`` and ``must_validate`` are held
to kubetpu's on the same (valid and malformed) profiles, and the
scheduler refuses a malformed profile or an unregistered lifecycle plugin
when it is built.
"""

import pytest

pytest.importorskip("jax")

import kubetpu  # noqa: F401
from kubetpu.framework import config as KC
from kubetpu.framework import lifecycle as klc
from kubetpu.framework import validation as KV

from kubetpu_torch.framework import lifecycle as plc
from kubetpu_torch.framework import validation as PV
from kubetpu_torch.sched import Scheduler as PScheduler

from .torch_port_util import RecordingClient, Side, to_port


def recording_plugin(lc, wait=0.0, reject_reserve=False, fail_pre_bind=False):
    """``tests/test_lifecycle.py``'s RecordingPlugin on the given lifecycle
    module (each side's plugin must subclass its own base)."""

    class RecordingPlugin(lc.LifecyclePlugin):
        def __init__(self):
            self.events = []

        def reserve(self, handle, pod, node_name):
            self.events.append(("reserve", pod.name))
            if reject_reserve:
                return lc.Status(lc.UNSCHEDULABLE, "no room reserved")
            return lc.Status()

        def unreserve(self, handle, pod, node_name):
            self.events.append(("unreserve", pod.name))

        def permit(self, handle, pod, node_name):
            if wait:
                self.events.append(("permit-wait", pod.name))
                return lc.Status(lc.WAIT), wait
            self.events.append(("permit-allow", pod.name))
            return lc.Status(), 0.0

        def pre_bind(self, handle, pod, node_name):
            self.events.append(("pre_bind", pod.name))
            if fail_pre_bind:
                return lc.Status(lc.UNSCHEDULABLE, "volume attach failed")
            return lc.Status()

        def post_bind(self, handle, pod, node_name):
            self.events.append(("post_bind", pod.name))

    return RecordingPlugin()


def lifecycle_profile():
    return KC.Profile(
        filters=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
        scores=KC.PluginSet(enabled=((KC.NODE_RESOURCES_FIT, 1),)),
        lifecycle=KC.PluginSet(enabled=(("TestPlugin", 1),)),
        default_spread_constraints=(),
    )



class LcSide(Side):
    """A Side whose registry holds the recording plugin."""

    def __init__(self, port, plugin_kw, **kw):
        lc = plc if port else klc
        self.plugin = recording_plugin(lc, **plugin_kw)
        reg = lc.Registry()
        reg.register("TestPlugin", lambda profile: self.plugin)
        super().__init__(port, lifecycle_profile(), registry=reg, **kw)

    def outcome(self):
        snap = self.s.cache.update_snapshot()
        return dict(
            events=list(self.plugin.events), bound=dict(self.c.bound),
            queued=len(self.s.queue),
            waiting=sorted((k, tuple(sorted(w.pending)))
                           for k, w in self.s.waiting_pods.items()),
            on_node=sorted(snap.nodes["n0"].pods),
            bind_errors=self.s.metrics.bind_errors,
        )


def both(scenario, plugin_kw=None, **kw):
    """Run ``scenario(side)`` on both sides; return values and outcomes
    (plugin events, bound map, queue length, waiting pods, the node's pods,
    bind errors) must be equal. Returns the port's outcome."""
    outs = []
    for port in (False, True):
        side = LcSide(port, plugin_kw or {}, **kw)
        side.s.on_node_add(side.W.make_node("n0", cpu_milli=4000))
        res = scenario(side)
        outs.append((res, side.outcome()))
    assert outs[1] == outs[0]
    return outs[1][1]


def test_full_lifecycle_order():
    def scenario(x):
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100))
        return x.step()

    out = both(scenario)
    assert out["bound"] == {"default/p": "n0"}
    assert out["events"] == [("reserve", "p"), ("permit-allow", "p"),
                             ("pre_bind", "p"), ("post_bind", "p")]


def test_reserve_rejection_unreserves_and_requeues():
    def scenario(x):
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100))
        return x.step()

    out = both(scenario, plugin_kw=dict(reject_reserve=True))
    assert out["bound"] == {} and out["queued"] == 1 and not out["on_node"]
    assert ("unreserve", "p") in out["events"]


def test_permit_wait_parks_then_allow_binds():
    def scenario(x):
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100))
        first = x.step()
        parked = (dict(x.c.bound), sorted(x.s.waiting_pods),
                  sorted(x.s.cache.update_snapshot().nodes["n0"].pods))
        x.s.get_waiting_pod("default/p").allow("TestPlugin")
        x.step()
        return first, parked

    out = both(scenario, plugin_kw=dict(wait=300.0))
    assert out["bound"] == {"default/p": "n0"}


def test_permit_reject_unreserves_and_forgets():
    def scenario(x):
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100))
        x.step()
        x.s.get_waiting_pod("default/p").reject("TestPlugin", "gang quorum failed")
        x.step()

    out = both(scenario, plugin_kw=dict(wait=300.0))
    assert out["bound"] == {} and not out["on_node"]
    assert ("unreserve", "p") in out["events"]


def test_permit_timeout_rejects():
    def scenario(x):
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100))
        x.step()
        waiting = x.s.get_waiting_pod("default/p") is not None
        x.clock.tick(6.0)
        x.step()
        return waiting, x.s.get_waiting_pod("default/p") is None

    out = both(scenario, plugin_kw=dict(wait=5.0))
    assert out["bound"] == {} and ("unreserve", "p") in out["events"]


def test_bind_failure_unreserves_and_retries():
    def scenario(x):
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100))
        x.step()
        x.step()
        x.clock.tick(30)
        for _ in range(4):
            x.step()

    out = both(scenario, fail_binds_for={"default/p"})
    assert out["bound"] == {"default/p": "n0"} and out["bind_errors"] == 1
    assert ("unreserve", "p") in out["events"]
    assert out["events"].count(("reserve", "p")) == 2


def test_pre_bind_failure_fails_binding_cycle():
    def scenario(x):
        x.s.on_pod_add(x.W.make_pod("p", cpu_milli=100))
        x.step()
        x.step()

    out = both(scenario, plugin_kw=dict(fail_pre_bind=True))
    assert out["bound"] == {} and out["bind_errors"] == 1
    assert ("unreserve", "p") in out["events"]


def test_waiting_pod_deleted_while_waiting():
    def scenario(x):
        pod = x.W.make_pod("p", cpu_milli=100)
        x.s.on_pod_add(pod)
        x.step()
        x.s.on_pod_delete(pod)
        return x.s.get_waiting_pod("default/p") is None

    out = both(scenario, plugin_kw=dict(wait=300.0))
    assert not out["on_node"] and ("unreserve", "p") in out["events"]


@pytest.mark.parametrize("lc", [klc, plc], ids=["kubetpu", "port"])
def test_registry_rejects_unknown_and_duplicate_names(lc):
    reg = lc.Registry()
    reg.register("A", lambda p: lc.LifecyclePlugin())
    with pytest.raises(ValueError):
        reg.register("A", lambda p: lc.LifecyclePlugin())
    with pytest.raises(KeyError):
        reg.build(["Missing"], KC.Profile())


def test_default_registry_names_and_runner():
    assert plc.default_registry().names() == klc.default_registry().names()
    runner = plc.default_registry().build(
        list(KC.Profile().lifecycle.names()), to_port(KC.Profile()))
    assert [p.name for p in runner.reserve_plugins] == ["VolumeBinding", "DynamicResources"]
    assert [p.name for p in runner.pre_bind_plugins] == ["VolumeBinding", "DynamicResources"]
    assert [p.name for p in runner.post_bind_plugins] == ["DynamicResources"]
    assert not runner.permit_plugins


@pytest.mark.parametrize("pod_kw, engaged", [
    ({}, False), ({"pvcs": ["c"]}, True), ({"claims": ["c"]}, True),
], ids=["plain", "pvc", "claim"])
def test_runner_skipped_only_for_pods_no_plugin_engages(pod_kw, engaged):
    """The in-tree plugins engage only pods with a PVC or a claim, and the
    scheduler runs no point for any other pod; a plugin that does not say
    which pods it engages engages every pod."""
    from kubetpu_torch.api import wrappers as PWR

    pod = PWR.make_pod("p", cpu_milli=100, **pod_kw)
    runner = plc.default_registry().build(
        list(KC.Profile().lifecycle.names()), to_port(KC.Profile()))
    assert runner.engages(pod) is engaged
    assert plc.LifecycleRunner([recording_plugin(plc)]).engages(pod)
    if engaged:
        return
    side = Side(True, KC.Profile())

    def forbidden(*a, **k):
        raise AssertionError("a lifecycle point ran for an unengaged pod")

    for point in ("run_reserve", "run_permit", "run_pre_bind",
                  "run_post_bind", "run_unreserve"):
        setattr(side.s.lifecycle, point, forbidden)
    side.s.on_node_add(side.W.make_node("n0", cpu_milli=4000))
    side.s.on_pod_add(pod)
    assert side.step() == 1 and side.c.bound == {"default/p": "n0"}


def _bad_profiles():
    return {
        "valid": KC.Profile(),
        "unknown-filter": KC.Profile(filters=KC.PluginSet(enabled=(("Nope", 1),))),
        "bad-weight": KC.Profile(scores=KC.PluginSet(
            enabled=((KC.NODE_RESOURCES_FIT, 0), (KC.NODE_AFFINITY, 101)))),
        "bad-shape": KC.Profile(scoring_strategy=KC.ScoringStrategy(
            type=KC.REQUESTED_TO_CAPACITY_RATIO, shape=((50, 3), (40, 11)))),
        "bad-lifecycle": KC.Profile(lifecycle=KC.PluginSet(enabled=(("Ghost", 1),))),
        "empty-name": KC.Profile(name=""),
    }


@pytest.mark.parametrize("name", sorted(_bad_profiles()))
def test_validation_equal_reference(name):
    prof = _bad_profiles()[name]
    want = KV.validate_profile(prof, klc.default_registry())
    got = PV.validate_profile(to_port(prof), plc.default_registry())
    assert got == want
    assert bool(got) == (name != "valid")
    cfg = KC.SchedulerConfiguration(profiles=(prof,))
    assert PV.validate_configuration(to_port(cfg)) == KV.validate_configuration(cfg)


@pytest.mark.parametrize("name", ["unknown-filter", "bad-weight", "bad-lifecycle"])
def test_scheduler_refuses_a_malformed_profile(name):
    with pytest.raises(ValueError, match="invalid scheduler configuration"):
        PScheduler(RecordingClient(), profile=to_port(_bad_profiles()[name]),
                   device="cpu")
