# Port copy of kubetpu/framework/lifecycle.py (no JAX in it). It differs in two
# ways. The port has no metrics registry yet, so the runner takes no ``metrics``
# and reads no timers (the reference's per-plugin and per-point duration
# histograms come back with the metrics slice). And a plugin may say which pods
# it ``engages``: the scheduler skips the runner for a pod that no plugin
# engages (the in-tree plugins engage only pods with a PVC or a resource claim;
# their hooks return at once for any other pod), where the reference runs every
# point for every pod. The outcome is the same.
"""Host-side lifecycle extension points: Reserve / Permit / PreBind /
PostBind, waiting pods, and the pluggable registry.

Reference surfaces:
- ReservePlugin (staging/src/k8s.io/kube-scheduler/framework/interface.go:636):
  ``Reserve`` runs after assume, in order; on any failure every Reserve
  plugin's ``Unreserve`` runs in REVERSE order and the pod is rejected.
- PermitPlugin (interface.go:680): approve / reject / wait-with-timeout;
  waiting pods are held before binding (WaitingPod, Allow/Reject per
  plugin; frameworkImpl.WaitOnPermit). Timeout ⇒ rejection.
- PreBindPlugin (interface.go:652): runs in the binding cycle just before
  the bind API call (VolumeBinding does its PV/PVC API writes here); a
  failure fails the binding cycle → Unreserve + requeue.
- PostBindPlugin (interface.go:669): informational, after a successful bind.
- Registry (pkg/scheduler/framework/plugins/registry.go:50): name → factory;
  profiles enable plugins by name, out-of-tree plugins register the same
  way (the reference's app.WithPlugin / frameworkplugins.NewInTreeRegistry
  merge).

One plugin object may implement any subset of the four points (reference
plugins implement multiple interfaces); the runner inspects which methods
are overridden.

These points are HOST-side by design: the tensor path (Filter/Score) stays
on device, while Reserve/Permit/PreBind are control-flow around binding —
exactly the reference's split between the scheduling cycle's compute and
the binding cycle's I/O.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ..api import types as t

# Status codes (fwk.Status)
SUCCESS = "Success"
UNSCHEDULABLE = "Unschedulable"
WAIT = "Wait"
ERROR = "Error"


@dataclass(frozen=True)
class Status:
    code: str = SUCCESS
    reason: str = ""
    plugin: str = ""

    @property
    def ok(self) -> bool:
        return self.code == SUCCESS


class LifecyclePlugin:
    """Base for host-side lifecycle plugins. Override any subset of the
    four extension-point methods; un-overridden points are skipped (the
    runner checks method identity, so a subclass pays only for what it
    implements)."""

    name = "LifecyclePlugin"

    # Whether any hook does something for this pod. A plugin that
    # overrides it promises that every hook is a no-op for a pod it does
    # not engage, so the scheduler may skip the runner for that pod.
    def engages(self, pod: t.Pod) -> bool:
        return True

    # Reserve (interface.go:636). Return a non-ok Status to reject.
    def reserve(self, handle: Any, pod: t.Pod, node_name: str) -> Status:
        return Status()

    def unreserve(self, handle: Any, pod: t.Pod, node_name: str) -> None:
        pass

    # Permit (interface.go:680). Return (Status, timeout_seconds); a WAIT
    # status parks the pod as a waiting pod until every waiting plugin
    # allows it, rejects it, or the smallest timeout fires.
    def permit(
        self, handle: Any, pod: t.Pod, node_name: str
    ) -> tuple[Status, float]:
        return Status(), 0.0

    # PreBind (interface.go:652) — runs in the (async) binding cycle.
    def pre_bind(self, handle: Any, pod: t.Pod, node_name: str) -> Status:
        return Status()

    # PostBind (interface.go:669) — informational.
    def post_bind(self, handle: Any, pod: t.Pod, node_name: str) -> None:
        pass


def _overrides(plugin: LifecyclePlugin, method: str) -> bool:
    return getattr(type(plugin), method) is not getattr(LifecyclePlugin, method)


@dataclass
class WaitingPod:
    """fwk.WaitingPod: a permitted-with-Wait pod parked before binding.
    ``pending`` holds the plugins still waiting; ``Allow``/``Reject`` are
    the per-plugin verdicts (frameworkImpl.waitingPodsMap semantics)."""

    pod: t.Pod
    node_name: str
    info: Any                     # QueuedPodInfo riding through binding
    pending: set[str] = field(default_factory=set)
    deadline: float = 0.0
    rejected: Status | None = None

    def allow(self, plugin: str) -> None:
        self.pending.discard(plugin)

    def reject(self, plugin: str, reason: str = "") -> None:
        self.rejected = Status(UNSCHEDULABLE, reason or "rejected", plugin)

    @property
    def decided(self) -> bool:
        return self.rejected is not None or not self.pending


class LifecycleRunner:
    """Orders and runs the four extension points for one profile."""

    def __init__(self, plugins: list[LifecyclePlugin]) -> None:
        self.reserve_plugins = [p for p in plugins if _overrides(p, "reserve")
                                or _overrides(p, "unreserve")]
        self.permit_plugins = [p for p in plugins if _overrides(p, "permit")]
        self.pre_bind_plugins = [p for p in plugins if _overrides(p, "pre_bind")]
        self.post_bind_plugins = [p for p in plugins if _overrides(p, "post_bind")]
        self._engage = [p.engages for p in plugins]
        self._engages_all = not all(_overrides(p, "engages") for p in plugins)

    def engages(self, pod) -> bool:
        """Whether any plugin does something for ``pod`` (see
        ``LifecyclePlugin.engages``)."""
        return self._engages_all or any(f(pod) for f in self._engage)

    def __bool__(self) -> bool:
        return bool(
            self.reserve_plugins or self.permit_plugins
            or self.pre_bind_plugins or self.post_bind_plugins
        )

    def run_reserve(self, handle, pod, node_name) -> Status:
        """RunReservePluginsReserve (framework.go): first failure wins; the
        CALLER must then run_unreserve (the reference unreserves all
        plugins, including ones never reserved — Unreserve must be
        idempotent)."""
        for p in self.reserve_plugins:
            try:
                st = p.reserve(handle, pod, node_name)
            except Exception as e:  # plugin bug → Error status
                return Status(ERROR, f"{type(e).__name__}: {e}", p.name)
            if st is not None and not st.ok:
                return Status(st.code, st.reason, st.plugin or p.name)
        return Status()

    def run_unreserve(self, handle, pod, node_name) -> None:
        """RunReservePluginsUnreserve: reverse order, best-effort."""
        for p in reversed(self.reserve_plugins):
            try:
                p.unreserve(handle, pod, node_name)
            except Exception:
                pass

    def run_permit(
        self, handle, pod, node_name, now: float
    ) -> tuple[Status, set[str], float]:
        """RunPermitPlugins: returns (status, waiting plugin names,
        deadline). A WAIT from any plugin wins over successes; any
        rejection wins over everything."""
        waiting: set[str] = set()
        deadline = 0.0
        for p in self.permit_plugins:
            try:
                st, timeout = p.permit(handle, pod, node_name)
            except Exception as e:
                return Status(ERROR, f"{type(e).__name__}: {e}", p.name), set(), 0.0
            if st is None or st.ok:
                continue
            if st.code == WAIT:
                waiting.add(p.name)
                dl = now + max(timeout, 0.0)
                deadline = dl if deadline == 0.0 else min(deadline, dl)
            else:
                return Status(st.code, st.reason, st.plugin or p.name), set(), 0.0
        if waiting:
            return Status(WAIT, "waiting on permit"), waiting, deadline
        return Status(), set(), 0.0

    def run_pre_bind(self, handle, pod, node_name) -> Status:
        for p in self.pre_bind_plugins:
            try:
                st = p.pre_bind(handle, pod, node_name)
            except Exception as e:
                return Status(ERROR, f"{type(e).__name__}: {e}", p.name)
            if st is not None and not st.ok:
                return Status(st.code, st.reason, st.plugin or p.name)
        return Status()

    def run_post_bind(self, handle, pod, node_name) -> None:
        for p in self.post_bind_plugins:
            try:
                p.post_bind(handle, pod, node_name)
            except Exception:
                pass


PluginFactory = Callable[..., LifecyclePlugin]


class Registry:
    """Name-keyed plugin factory registry (plugins/registry.go:50 +
    app.WithPlugin out-of-tree merge). Factories take the profile as their
    single argument."""

    def __init__(self) -> None:
        self._factories: dict[str, PluginFactory] = {}

    def register(self, name: str, factory: PluginFactory) -> None:
        if name in self._factories:
            raise ValueError(f"a plugin named {name!r} already exists")
        self._factories[name] = factory

    def merge(self, other: "Registry") -> None:
        for name, factory in other._factories.items():
            self.register(name, factory)

    def names(self) -> list[str]:
        return sorted(self._factories)

    def build(self, names: list[str], profile) -> LifecycleRunner:
        plugins: list[LifecyclePlugin] = []
        for name in names:
            factory = self._factories.get(name)
            if factory is None:
                raise KeyError(
                    f"lifecycle plugin {name!r} is not registered "
                    f"(known: {self.names()})"
                )
            plugin = factory(profile)
            plugin.name = name
            plugins.append(plugin)
        return LifecycleRunner(plugins)


def default_registry() -> Registry:
    """In-tree lifecycle plugins (NewInTreeRegistry analog)."""
    from .dynamicresources import DynamicResourcesPlugin
    from .volumebinding import VolumeBindingPlugin

    reg = Registry()
    reg.register("VolumeBinding", VolumeBindingPlugin)
    reg.register("DynamicResources", DynamicResourcesPlugin)
    return reg
