# Port copy of kubetpu/bridge/server.py; the device calls are the port's (see the docstring).
"""Scheduler-extender webhook server — the framework's primary integration
seam with a real kube-scheduler.

The reference scheduler calls extenders over JSON/HTTP POST
(pkg/scheduler/extender.go:44 ``HTTPExtender``, ``send`` :399) from
``findNodesThatPassExtenders`` (schedule_one.go:886, serial) and
``prioritizeNodes`` (schedule_one.go:987, concurrent), with wire types from
staging/src/k8s.io/kube-scheduler/extender/v1/types.go:73-132. This module
is the *server* half: a real kube-scheduler configured with

    extenders:
    - urlPrefix: http://<this-host>:<port>
      filterVerb: filter
      prioritizeVerb: prioritize
      bindVerb: bind            # optional
      preemptVerb: preempt      # optional
      weight: 5
      nodeCacheCapable: true    # send node names, not full objects
      ignorable: true           # health-gated CPU fallback (SURVEY §5)

offloads Filter + Score to the batch kernels. Field names follow Go's
default (untagged) encoding: ``Pod``, ``Nodes``, ``NodeNames``,
``FailedNodes``, ``FailedAndUnresolvableNodes``, ``Error``, ``Host``,
``Score`` — Go's decoder is case-insensitive, but we emit the canonical
spelling.

Two node-state modes, as in the reference config
(pkg/scheduler/apis/config/types.go:267 ``Extender.NodeCacheCapable``):

- ``NodeCacheCapable=true``: requests carry only candidate node NAMES; node
  and pod state comes from this server's cache, fed by the delta-ingestion
  endpoints (``/cache/nodes``, ``/cache/pods`` — the host half of SURVEY
  §2.9's delta streaming).
- ``NodeCacheCapable=false``: requests carry full v1.Node objects; they are
  decoded and used directly (pod-derived state is whatever the cache knows).

``Ignorable`` is enforced by the *caller* (scheduler skips a dead extender,
extender.go IsIgnorable); this server's contract is to always answer with a
well-formed body whose ``Error`` field carries failures, so a non-ignorable
configuration fails scheduling loudly rather than silently.

Port of ``kubetpu/bridge/server.py`` (the wire handling is the reference's
code). The backend takes a ``device`` (default ``"cuda"``): on CUDA the
``filter`` and ``preempt`` verbs take their per-plugin masks from the
``filter_component_masks`` kernel (the request's pod row, packed a bit a
plugin) and ``prioritize`` its mask and total from ``filter_score``; on the
CPU the plain ``filter_component_masks_rows_plain`` /
``feasible_and_scores`` answer, with the same bodies. The encoded node
block stays on the device across requests (``prev_nt`` plus a
``runtime.ResidentNodeState``), so a request ships its pod and the node
rows that moved since the previous one, not the whole block.

Deviation, by design: ``ThreadingHTTPServer`` answers each request on its
own thread, and the reference launches its device work outside its lock
(kubetpu/bridge/server.py:170, :225). Here one lock is held across each
request's encode, launches and fetch: the kernels' launch counts and the
resident node block are not thread-safe, and a request must not see the
block another request's encode is scattering into.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np
import torch

from ..api import types as t
from ..framework import config as C
from ..framework import runtime as rt
from ..state.snapshot import Cache
from .convert import node_from_v1, pod_from_v1

# MaxExtenderPriority (extender/v1/types.go:28): extender scores are 0..10;
# the scheduler rescales by weight * MaxNodeScore / MaxExtenderPriority
# (schedule_one.go:1015).
MAX_EXTENDER_PRIORITY = 10


class ExtenderBackend:
    """Cache + profile + the device Filter/Score path behind the verbs."""

    def __init__(
        self,
        profile: C.Profile | None = None,
        bind_fn: Callable[[t.Pod, str], None] | None = None,
        metrics_source: Callable[[], str] | None = None,
        device="cuda",
    ) -> None:
        """``metrics_source``: optional Prometheus-text provider served at
        GET /metrics (every reference binary exposes /metrics,
        component-base/metrics legacy registry). ``device``: where the
        verbs' Filter and Score run — ``"cuda"`` (the kernels) or ``"cpu"``
        (the plain PyTorch versions)."""
        self.profile = profile or C.minimal_profile()
        self.device = torch.device(device)
        self.cache = Cache()
        self.lock = threading.Lock()
        self._bind_fn = bind_fn
        self.metrics_source = metrics_source
        # optional live-config provider served at GET /configz (the
        # reference's configz endpoint, SURVEY §5 observability)
        self.configz_source: Callable[[], dict] | None = None
        # persistent snapshot: update_snapshot(self._snapshot) re-clones only
        # NodeInfos whose generation moved, so an unchanged cache costs O(Δ)
        # per webhook hit (cache.go:190 UpdateSnapshot semantics)
        self._snapshot = None
        self._prev_nt = None  # incremental NodeTensors (encode_snapshot prev)
        # the encoded node block, resident on the device across requests
        self._resident = rt.ResidentNodeState(self.device)
        # pods seen in filter/prioritize args, by uid — bind args carry only
        # the pod's identity (ExtenderBindingArgs), so the real requests for
        # cache accounting come from the preceding scheduling call
        import collections

        self._seen_pods: "collections.OrderedDict[str, t.Pod]" = (
            collections.OrderedDict()
        )
        self._seen_cap = 16384

    # ---- delta ingestion (NodeCacheCapable state) -----------------------

    def upsert_nodes(self, nodes: list[t.Node]) -> None:
        with self.lock:
            for n in nodes:
                self.cache.add_node(n)  # upsert (cache.add_node semantics)

    def remove_nodes(self, names: list[str]) -> None:
        with self.lock:
            for name in names:
                self.cache.remove_node(name)

    def upsert_pods(self, pods: list[t.Pod]) -> None:
        with self.lock:
            for p in pods:
                if p.node_name:
                    self.cache.add_pod(p)  # replace-on-add
                elif self.cache.has_pod(p.uid):
                    self.cache.remove_pod(p)

    def remove_pods(self, pods: list[t.Pod]) -> None:
        with self.lock:
            for p in pods:
                if self.cache.has_pod(p.uid):
                    self.cache.remove_pod(p)

    # ---- verb implementations ------------------------------------------

    def _remember(self, pod: t.Pod) -> None:
        self._seen_pods[pod.uid] = pod
        self._seen_pods.move_to_end(pod.uid)
        while len(self._seen_pods) > self._seen_cap:
            self._seen_pods.popitem(last=False)

    def _encode(self, pod: t.Pod, extra_nodes: list[t.Node] | None):
        """One-pod batch over the shared cache (incremental snapshot:
        update_snapshot(prev) re-clones only changed NodeInfos), its node
        block delta-uploaded into the resident one. The caller holds
        ``self.lock`` until it has fetched what it launched.

        Non-cache-capable requests UPSERT their node objects first — the
        cache is the union of everything seen, with requested nodes
        refreshed per request. The union is what keeps bind/preempt and
        cross-node affinity/spread state working in that mode (responses
        are still restricted to the request's candidates by name); a node
        deleted from the cluster lingers until a /cache/nodes Remove —
        non-cache mode has no delete signal, one reason the reference
        recommends NodeCacheCapable for stateful extenders."""
        self._remember(pod)
        if extra_nodes:
            for n in extra_nodes:
                self.cache.add_node(n)
        self._snapshot = self.cache.update_snapshot(self._snapshot)
        batch = rt.encode_batch(
            self._snapshot, [pod], self.profile, prev_nt=self._prev_nt,
            resident=self._resident, device=self.device,
        )
        self._prev_nt = batch.node_tensors
        params = rt.score_params(self.profile, batch.resource_names)
        return batch, params

    def _components(self, b, params):
        """The first pod's five per-plugin Filter masks as host arrays (None
        where a plugin is absent): its row of packed bits from the
        ``filter_component_masks`` kernel on CUDA, from the plain
        ``filter_component_masks_rows_plain`` on the CPU, in one copy."""
        if b.device.type == "cpu":
            from ..sched.flightrecorder import filter_component_masks_rows_plain as masks
        else:
            from ..kernels import filter_component_masks as masks
        bits, present = masks(b, params, [0])
        row = bits[0].cpu().numpy()
        comps = ((row >> np.arange(5, dtype=np.uint8)[:, None]) & 1).astype(bool)
        return tuple(comps[c] if on else None for c, on in enumerate(present))

    def filter(self, args: dict) -> dict:
        """ExtenderArgs → ExtenderFilterResult. Distinguishes resolvable
        failures (FailedNodes) from victim-independent ones
        (FailedAndUnresolvableNodes — preemption cannot help;
        extender/v1/types.go:96-99) via the split filter masks.

        Only the static per-node predicates (labels, taints, unschedulable,
        node name/affinity) are victim-independent. Spread and pod-affinity
        failures are pod-state-dependent — the reference returns plain
        Unschedulable for them (interpodaffinity/filtering.go:436,
        podtopologyspread/filtering.go Filter) so the scheduler keeps those
        nodes as preemption candidates — as do fit/ports failures."""
        pod = pod_from_v1(args.get("Pod") or {})
        node_names, extra_nodes, cache_capable = self._candidates(args)
        with self.lock:
            batch, params = self._encode(pod, extra_nodes)
            static, fit, ports_ok, spread_ok, pa_ok = self._components(
                batch.device, params
            )
        unresolvable = ~static
        resolvable_fail = np.zeros_like(unresolvable)
        for part in (fit, ports_ok, spread_ok, pa_ok):
            if part is not None:
                resolvable_fail = resolvable_fail | ~part
        wanted = node_names if node_names is not None else batch.node_names
        name_to_idx = {n: i for i, n in enumerate(batch.node_names)}
        passing: list[str] = []
        failed: dict[str, str] = {}
        failed_unresolvable: dict[str, str] = {}
        for name in wanted:
            i = name_to_idx.get(name)
            if i is None or i >= batch.num_nodes:
                failed[name] = "node not in extender cache"
                continue
            if unresolvable[i]:
                failed_unresolvable[name] = "node(s) didn't satisfy plugin filters"
            elif resolvable_fail[i]:
                failed[name] = "node(s) had insufficient resources or ports"
            else:
                passing.append(name)
        result: dict = {
            "Nodes": None,
            "NodeNames": None,
            "FailedNodes": failed,
            "FailedAndUnresolvableNodes": failed_unresolvable,
            "Error": "",
        }
        if cache_capable:
            result["NodeNames"] = passing
        else:
            passing_set = set(passing)
            items = [
                n for n in (args.get("Nodes") or {}).get("Items") or []
                if ((n.get("metadata") or {}).get("name")) in passing_set
            ]
            result["Nodes"] = {"Items": items}
        return result

    def prioritize(self, args: dict) -> list[dict]:
        """ExtenderArgs → HostPriorityList. Scores are normalized to the
        0..MaxExtenderPriority contract (the scheduler multiplies by
        weight*MaxNodeScore/MaxExtenderPriority, schedule_one.go:1015)."""
        pod = pod_from_v1(args.get("Pod") or {})
        node_names, extra_nodes, _ = self._candidates(args)
        with self.lock:
            batch, params = self._encode(pod, extra_nodes)
            mask, total = rt.filter_score_batch(batch.device, params)
            mask = mask[0].cpu().numpy()
            total = total[0].cpu().numpy()
        wanted = node_names if node_names is not None else batch.node_names
        name_to_idx = {n: i for i, n in enumerate(batch.node_names)}
        idxs = [name_to_idx[n] for n in wanted if n in name_to_idx]
        hi = max((int(total[i]) for i in idxs if mask[i]), default=0)
        out = []
        for name in wanted:
            i = name_to_idx.get(name)
            score = 0
            if i is not None and i < batch.num_nodes and mask[i] and hi > 0:
                score = int(total[i]) * MAX_EXTENDER_PRIORITY // hi
            out.append({"Host": name, "Score": score})
        return out

    def bind(self, args: dict) -> dict:
        """ExtenderBindingArgs → ExtenderBindingResult. Delegates the actual
        API write to ``bind_fn`` (the reference extender calls
        pods/binding itself, extender_test.go Bind); default records the
        assignment in the local cache."""
        name = args.get("PodName", "")
        namespace = args.get("PodNamespace", "default")
        uid = args.get("PodUID", "") or f"{namespace}/{name}"
        node = args.get("Node", "")
        try:
            # bind args carry only identity; recover the real spec (requests,
            # labels, ports) from the preceding filter/prioritize call so the
            # cache accounting is correct, not a zero-request placeholder
            seen = self._seen_pods.get(uid)
            if seen is not None:
                pod = seen.with_node(node)
            else:
                pod = t.Pod(
                    name=name, namespace=namespace, uid=uid, node_name=node
                )
            if self._bind_fn is not None:
                self._bind_fn(pod, node)
            else:
                with self.lock:
                    if not self.cache.has_node(node):
                        raise KeyError(f"unknown node {node!r}")
                    if self.cache.has_pod(uid):
                        self.cache.remove_pod(pod)
                    self.cache.add_pod(pod)
            return {"Error": ""}
        except Exception as e:  # report, never crash the webhook
            return {"Error": str(e)}

    def preempt(self, args: dict) -> dict:
        """ExtenderPreemptionArgs → ExtenderPreemptionResult. Converts the
        scheduler's proposed victim map to MetaVictims, dropping nodes this
        extender's filters reject outright (the extender may only shrink the
        candidate set — extender.go ProcessPreemption)."""
        pod = pod_from_v1(args.get("Pod") or {})
        victims = args.get("NodeNameToVictims") or {}
        meta = args.get("NodeNameToMetaVictims") or {}
        candidates = list(victims.keys() or meta.keys())
        with self.lock:
            batch, params = self._encode(pod, None)
            static = self._components(batch.device, params)[0]
        name_to_idx = {n: i for i, n in enumerate(batch.node_names)}
        out: dict[str, dict] = {}
        for node in candidates:
            i = name_to_idx.get(node)
            if i is None or not static[i]:
                continue  # victim-independent failure: removal can't help
            if node in meta:
                out[node] = meta[node]
            else:
                v = victims.get(node) or {}
                out[node] = {
                    "Pods": [
                        {"UID": (p.get("metadata") or {}).get("uid", "")}
                        for p in v.get("Pods") or ()
                    ],
                    "NumPDBViolations": v.get("NumPDBViolations", 0),
                }
        return {"NodeNameToMetaVictims": out}

    # ---- helpers --------------------------------------------------------

    def _candidates(self, args: dict):
        """(node_names | None, extra request nodes, cache_capable)."""
        names = args.get("NodeNames")
        if names is not None:
            return list(names), None, True
        items = (args.get("Nodes") or {}).get("Items") or []
        nodes = [node_from_v1(j) for j in items]
        return [n.name for n in nodes], nodes, False


class _Handler(BaseHTTPRequestHandler):
    backend: ExtenderBackend  # set by server factory
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:  # quiet by default
        pass

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b"{}"
        return json.loads(raw or b"{}")

    def _reply(self, obj, status: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        be = self.backend
        path = self.path.rstrip("/")
        try:
            args = self._read_json()
        except json.JSONDecodeError:
            self._reply({"Error": "Decode error"}, status=400)
            return
        try:
            if path.endswith("/filter"):
                self._reply(be.filter(args))
            elif path.endswith("/prioritize"):
                self._reply(be.prioritize(args))
            elif path.endswith("/bind"):
                self._reply(be.bind(args))
            elif path.endswith("/preempt"):
                self._reply(be.preempt(args))
            elif path.endswith("/cache/nodes"):
                be.upsert_nodes([node_from_v1(j) for j in args.get("Nodes") or ()])
                be.remove_nodes(list(args.get("Remove") or ()))
                self._reply({"Error": ""})
            elif path.endswith("/cache/pods"):
                be.upsert_pods([pod_from_v1(j) for j in args.get("Pods") or ()])
                be.remove_pods([pod_from_v1(j) for j in args.get("Remove") or ()])
                self._reply({"Error": ""})
            elif path.endswith("/healthz"):
                self._reply({"ok": True})
            elif path.endswith("/configz"):
                if be.configz_source is None:
                    self._reply({"Error": "no config source wired"}, status=404)
                else:
                    self._reply(be.configz_source())
            elif path.endswith("/metrics"):
                if be.metrics_source is None:
                    self._reply({"Error": "no metrics source wired"}, status=404)
                else:
                    body = be.metrics_source().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
            else:
                self._reply({"Error": f"Unknown verb {path!r}"}, status=404)
        except Exception as e:
            # a well-formed error body lets an Ignorable caller skip us
            self._reply({"Error": f"{type(e).__name__}: {e}"}, status=500)

    do_GET = do_POST


class ExtenderServer:
    """In-process webhook server (the httptest.NewServer analog the
    reference integration tests use, extender_test.go:297)."""

    def __init__(
        self,
        backend: ExtenderBackend | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        device="cuda",
    ) -> None:
        """``device``: the device of the backend made when ``backend`` is
        None (default ``"cuda"``)."""
        self.backend = backend or ExtenderBackend(device=device)
        handler = type("BoundHandler", (_Handler,), {
            "backend": self.backend,
            # webhook request/response bodies are small: without
            # TCP_NODELAY, Nagle + the scheduler's delayed ACK stalls every
            # keep-alive extender call ~40 ms (same knob as the apiserver)
            "disable_nagle_algorithm": True,
        })
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ExtenderServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
