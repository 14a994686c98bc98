"""The port's extender bridge equals kubetpu's.

- ``bridge.quantity`` and ``bridge.convert`` against kubetpu's on the cases
  of ``tests/test_bridge.py`` (quantities, the v1 pod and node envelopes,
  the sidecar accounting, ``pod_to_v1``).
- ``bridge.server``: the same request sequences posted over HTTP to a
  kubetpu ``ExtenderServer`` and to the port's on ``device="cpu"``, each
  with its own cache: every verb's response body (``filter`` in both node
  modes, ``prioritize``, ``bind``, ``preempt``, the cache endpoints, the
  error bodies) must be equal, body for body.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import kubetpu  # noqa: F401
from kubetpu.api.wrappers import make_pod
from kubetpu.bridge import ExtenderBackend as KBackend
from kubetpu.bridge import ExtenderServer as KServer
from kubetpu.bridge import convert as KCV
from kubetpu.bridge import quantity as KQ
from kubetpu.framework import config as KC

from kubetpu_torch.bridge import ExtenderBackend as PBackend
from kubetpu_torch.bridge import ExtenderServer as PServer
from kubetpu_torch.bridge import convert as PCV
from kubetpu_torch.bridge import quantity as PQ

from .test_bridge import V1_NODE, V1_POD, _v1_node, _v1_pod
from .torch_port_util import to_port

QUANTITIES = [
    "100m", "1", "2", "0.5", "1500m", "2.5", "0.1", "128974848", "129e6",
    "129M", "123Mi", "1Gi", "1G", "64Ki", "1Ti", "5", "1k", "2E", "2e3",
    "1.5Gi", "3Ei", 7, 0.25,
]


@pytest.mark.parametrize("q", QUANTITIES, ids=str)
def test_quantity_equal(q):
    assert PQ.parse_quantity(q) == KQ.parse_quantity(q)
    assert PQ.quantity_to_int(q) == KQ.quantity_to_int(q)
    assert PQ.quantity_to_milli(q) == KQ.quantity_to_milli(q)
    for name in ("cpu", "memory", "pods"):
        assert PQ.canonical_resource(name, q) == KQ.canonical_resource(name, q)


SIDECAR_POD = {
    "metadata": {"name": "p", "namespace": "default"},
    "spec": {
        "containers": [
            {"name": "app", "resources": {"requests": {"cpu": "1"}}},
        ],
        "initContainers": [
            {"name": "sidecar", "restartPolicy": "Always",
             "resources": {"requests": {"cpu": "500m"}}},
            {"name": "setup", "resources": {"requests": {"cpu": "1200m"}}},
        ],
    },
}
POD_CASES = {
    "v1-pod": V1_POD,
    "sidecar": SIDECAR_POD,
    "bare": {"metadata": {"name": "x"}},
    "bound": _v1_pod("b", cpu="2", memory="3Gi", node="n1"),
}


@pytest.mark.parametrize("case", sorted(POD_CASES))
def test_pod_from_v1_equal(case):
    got = PCV.pod_from_v1(POD_CASES[case])
    assert got == to_port(KCV.pod_from_v1(POD_CASES[case]))
    # and back: pod_to_v1 writes the same envelope on both sides
    assert PCV.pod_to_v1(got) == KCV.pod_to_v1(KCV.pod_from_v1(POD_CASES[case]))


@pytest.mark.parametrize("node", [V1_NODE, _v1_node("n", cpu="8", memory="3Gi",
                                                    unschedulable=True)],
                         ids=["v1-node", "unschedulable"])
def test_node_from_v1_equal(node):
    assert PCV.node_from_v1(node) == to_port(KCV.node_from_v1(node))


def test_pod_to_v1_round_trip_equal():
    pod = make_pod("web", namespace="prod", cpu_milli=750, memory=256 * 1024**2,
                   labels={"app": "web"}, node_selector={"disktype": "ssd"},
                   priority=10, host_ports=[8080], scheduler_name="custom")
    assert PCV.pod_to_v1(to_port(pod)) == KCV.pod_to_v1(pod)
    assert PCV.pod_from_v1(PCV.pod_to_v1(to_port(pod))) == to_port(
        KCV.pod_from_v1(KCV.pod_to_v1(pod)))


# ------------------------------------------------------------- the server


def _post(url: str, body) -> tuple[int, object]:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def servers():
    k = KServer(KBackend(profile=KC.Profile())).start()
    p = PServer(PBackend(profile=to_port(KC.Profile()), device="cpu")).start()
    yield k, p
    k.close()
    p.close()


def _replay(servers, requests):
    """Post every (path, body) to both servers; every reply must be equal."""
    k, p = servers
    replies = []
    for path, body in requests:
        want = _post(k.url + path, body)
        got = _post(p.url + path, body)
        assert got == want, (path, got, want)
        replies.append(got)
    return replies


HOST = "kubernetes.io/hostname"


def _anti_pod():
    pod = _v1_pod("p-anti", cpu="1")
    pod["spec"]["affinity"] = {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": HOST, "labelSelector": {"matchLabels": {"app": "db"}},
        }],
    }}
    return pod


def _db_pod():
    db = _v1_pod("db", cpu="1", node="a0")
    db["metadata"]["labels"] = {"app": "db"}
    return db


SCENARIOS = {
    "filter-cache-capable": [
        ("/cache/nodes", {"Nodes": [_v1_node("n0", cpu="4"), _v1_node("n1", cpu="1"),
                                    _v1_node("n2", cpu="4", unschedulable=True)]}),
        ("/filter", {"Pod": _v1_pod("p", cpu="2"),
                     "NodeNames": ["n0", "n1", "n2", "ghost"]}),
    ],
    "filter-full-nodes": [
        ("/filter", {"Pod": _v1_pod("p", cpu="2"), "Nodes": {"Items": [
            _v1_node("m0", cpu="4"), _v1_node("m1", cpu="1")]}}),
        ("/prioritize", {"Pod": _v1_pod("p", cpu="2"), "Nodes": {"Items": [
            _v1_node("m0", cpu="4"), _v1_node("m1", cpu="1")]}}),
    ],
    "union-view-bind": [
        ("/filter", {"Pod": _v1_pod("p", cpu="2"),
                     "Nodes": {"Items": [_v1_node("u0", cpu="4")]}}),
        ("/bind", {"PodName": "p", "PodNamespace": "default",
                   "PodUID": "default/p", "Node": "u0"}),
        ("/filter", {"Pod": _v1_pod("q", cpu="3"),
                     "Nodes": {"Items": [_v1_node("u0", cpu="4")]}}),
    ],
    "affinity-resolvable": [
        ("/cache/nodes", {"Nodes": [_v1_node("a0", cpu="4", labels={HOST: "a0"}),
                                    _v1_node("a1", cpu="4", labels={HOST: "a1"})]}),
        ("/cache/pods", {"Pods": [_db_pod()]}),
        ("/filter", {"Pod": _anti_pod(), "NodeNames": ["a0", "a1"]}),
        ("/prioritize", {"Pod": _anti_pod(), "NodeNames": ["a0", "a1"]}),
        ("/preempt", {"Pod": _anti_pod(), "NodeNameToVictims": {
            "a0": {"Pods": [{"metadata": {"uid": "default/db"}}],
                   "NumPDBViolations": 1}}}),
    ],
    "prioritize": [
        ("/cache/nodes", {"Nodes": [_v1_node("n0", cpu="4"), _v1_node("n1", cpu="8")]}),
        ("/cache/pods", {"Pods": [_v1_pod("busy", cpu="3", node="n0")]}),
        ("/prioritize", {"Pod": _v1_pod("p", cpu="1"), "NodeNames": ["n0", "n1"]}),
    ],
    "bind-real-requests": [
        ("/cache/nodes", {"Nodes": [_v1_node("n0", cpu="4")]}),
        ("/filter", {"Pod": _v1_pod("p", cpu="4"), "NodeNames": ["n0"]}),
        ("/bind", {"PodName": "p", "PodNamespace": "default",
                   "PodUID": "default/p", "Node": "n0"}),
        ("/filter", {"Pod": _v1_pod("q", cpu="1"), "NodeNames": ["n0"]}),
        ("/bind", {"PodName": "p", "PodNamespace": "default",
                   "PodUID": "default/p", "Node": "nope"}),
    ],
    "preempt-meta-victims": [
        ("/cache/nodes", {"Nodes": [_v1_node("n0"), _v1_node("n1", unschedulable=True)]}),
        ("/preempt", {"Pod": _v1_pod("p", cpu="1"), "NodeNameToVictims": {
            "n0": {"Pods": [{"metadata": {"uid": "u1"}}], "NumPDBViolations": 0},
            "n1": {"Pods": [{"metadata": {"uid": "u2"}}], "NumPDBViolations": 0}}}),
        ("/preempt", {"Pod": _v1_pod("p", cpu="1"), "NodeNameToMetaVictims": {
            "n0": {"Pods": [{"UID": "u1"}], "NumPDBViolations": 2},
            "ghost": {"Pods": [{"UID": "u3"}], "NumPDBViolations": 0}}}),
    ],
    "cache-removal-and-errors": [
        ("/cache/nodes", {"Nodes": [_v1_node("n0")]}),
        ("/cache/pods", {"Pods": [_v1_pod("b", node="n0")]}),
        ("/cache/pods", {"Remove": [_v1_pod("b", node="n0")]}),
        ("/cache/nodes", {"Remove": ["n0"]}),
        ("/filter", {"Pod": _v1_pod("p"), "NodeNames": ["n0"]}),
        ("/frobnicate", {}),
        ("/filter", b"{nope"),
        ("/healthz", {}),
    ],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_server_replies_equal(servers, scenario):
    _replay(servers, SCENARIOS[scenario])


@pytest.mark.parametrize("seed", range(2))
def test_server_seeded_traffic_equal(servers, seed):
    """A seeded cluster (zones, taints, sizes), bound pods, then pods that
    each post filter and prioritize over every node, some also preempt and
    bind, one in non-cache-capable mode."""
    rng = np.random.default_rng(seed)
    nodes = [
        _v1_node(f"n{i}", cpu=str(int(rng.integers(2, 9))),
                 memory=f"{int(rng.integers(4, 33))}Gi",
                 labels={"zone": f"z{i % 3}", HOST: f"n{i}"},
                 unschedulable=bool(rng.random() < 0.1))
        for i in range(24)
    ]
    names = [n["metadata"]["name"] for n in nodes]
    bound = [
        _v1_pod(f"b{j}", cpu=f"{int(rng.integers(1, 15)) * 100}m",
                node=str(rng.choice(names)))
        for j in range(30)
    ]
    reqs = [("/cache/nodes", {"Nodes": nodes}), ("/cache/pods", {"Pods": bound})]
    for j in range(12):
        pod = _v1_pod(f"p{j}", cpu=f"{int(rng.integers(1, 40)) * 100}m",
                      memory=f"{int(rng.integers(1, 8))}Gi")
        if rng.random() < 0.3:
            pod["spec"]["nodeSelector"] = {"zone": f"z{int(rng.integers(0, 3))}"}
        reqs.append(("/filter", {"Pod": pod, "NodeNames": names}))
        reqs.append(("/prioritize", {"Pod": pod, "NodeNames": names}))
        if j % 4 == 1:
            reqs.append(("/preempt", {"Pod": pod, "NodeNameToVictims": {
                n: {"Pods": [{"metadata": {"uid": f"default/b{k}"}}],
                    "NumPDBViolations": k % 2}
                for k, n in enumerate(names[:6])}}))
        if j % 3 == 0:
            reqs.append(("/bind", {"PodName": f"p{j}", "PodNamespace": "default",
                                   "PodUID": f"default/p{j}",
                                   "Node": str(rng.choice(names))}))
    reqs.append(("/filter", {"Pod": _v1_pod("full", cpu="1"),
                             "Nodes": {"Items": nodes[:8]}}))
    replies = _replay(servers, reqs)
    # the traffic was not trivial: some nodes pass, some fail
    filt = [r for (path, _), (_, r) in zip(reqs, replies) if path == "/filter"]
    assert any(r["NodeNames"] for r in filt if r["NodeNames"] is not None)
    assert any(r["FailedNodes"] for r in filt)


def test_concurrent_requests_equal_serial(servers):
    """Requests that arrive together (one thread each, as a kube-scheduler's
    parallel Prioritize calls do) get the replies kubetpu's server gives
    them one at a time: the port holds one lock across each request's
    encode, launches and fetch."""
    import threading

    k, p = servers
    nodes = [_v1_node(f"c{i}", cpu=str(2 + i % 5), labels={HOST: f"c{i}"})
             for i in range(40)]
    for srv in servers:
        _post(srv.url + "/cache/nodes", {"Nodes": nodes})
        _post(srv.url + "/cache/pods", {"Pods": [_v1_pod(f"b{i}", cpu="1", node=f"c{i}")
                                                 for i in range(0, 40, 3)]})
    names = [n["metadata"]["name"] for n in nodes]
    reqs = [(verb, {"Pod": _v1_pod(f"q{j}", cpu=f"{1 + j % 4}"), "NodeNames": names})
            for j in range(12) for verb in ("/filter", "/prioritize")]
    want = [_post(k.url + path, body) for path, body in reqs]
    got = [None] * len(reqs)

    def one(i):
        got[i] = _post(p.url + reqs[i][0], reqs[i][1])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got == want


def test_backend_defaults_to_cuda():
    """The entry point's device defaults to the card (nothing launches)."""
    import inspect

    assert inspect.signature(PBackend.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(PServer.__init__).parameters["device"].default == "cuda"
