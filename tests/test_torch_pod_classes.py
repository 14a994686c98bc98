"""The pod classes of a batch (``framework.runtime.PodClasses``), on which
the ``filter_score`` kernel scores one pod a class and copies its rows to
the other pods.

The key (``runtime.POD_CLASS_KEY``) is held to every pod-indexed leaf that
the kernel's argument struct packs, each leaf is shown to split a class,
and the class-wise plain Filter+Score (the plain pair and normalize passes
on one pod a class, its rows copied to the class's pods) is held to the
all-pairs plain ``feasible_and_scores`` and to kubetpu's, bit for bit, on
small batches of the main paths' workloads. Tolerance: exact.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kubetpu  # noqa: F401
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.queue.nominator import Nominator
from kubetpu.state.snapshot import Cache

from kubetpu_torch import kernels
from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.parallel import mesh as M

from .test_torch_dra import _batches as dra_batches
from .test_torch_extender import extender_pair
from .torch_port_util import basic_cluster, port_batch_from_jax, port_cache, port_params, to_port

# the synthetic batch's sizes, P distinct from every other extent
P, N, R, K, G = 7, 12, 3, 2, 3
RA, DA, SP, DS, CSP = 4, 5, 2, 3, 2


def _synthetic(rng, same_pods=True) -> dict:
    """Numpy leaves with every leaf present; with ``same_pods`` every pod's
    rows are pod 0's."""

    def pods(shape, lo, hi, dtype):
        a = rng.integers(lo, hi, size=(P,) + shape).astype(dtype)
        if same_pods:
            a[:] = a[0]
        return a

    leaves = dict(
        alloc=rng.integers(1000, 4000, (N, R)).astype(np.int64),
        requested=rng.integers(0, 500, (N, R)).astype(np.int64),
        nonzero_requested=rng.integers(0, 500, (N, R)).astype(np.int64),
        pod_count=rng.integers(0, 5, N).astype(np.int32),
        allowed_pods=np.full(N, 110, dtype=np.int32),
        node_valid=np.ones(N, dtype=bool),
        requests=pods((R,), 0, 900, np.int64),
        nonzero_requests=pods((R,), 1, 900, np.int64),
        pod_valid=pods((), 1, 2, bool),
        static_mask=rng.random((2, N)) < 0.8,
        static_sig=pods((), 0, 2, np.int32),
        node_affinity_raw=rng.integers(0, 50, (2, N)).astype(np.int64),
        taint_prefer_raw=rng.integers(0, 3, (2, N)).astype(np.int64),
        score_sig=pods((), 0, 2, np.int32),
        image_sum_scores=rng.integers(0, 2**30, (2, N)).astype(np.int64),
        image_sig=pods((), 0, 2, np.int32),
        image_count=pods((), 0, 3, np.int32),
        pod_ports=pods((K,), 0, 2, bool),
        node_ports=rng.random((N, K)) < 0.2,
        port_conflict=np.eye(K, dtype=bool),
        nominated_node=rng.integers(-1, N, G).astype(np.int32),
        nominated_req=rng.integers(0, 300, (G, R)).astype(np.int64),
        nominated_gate=pods((G,), 0, 2, bool),
        nominated_ports=rng.random((G, K)) < 0.3,
        nominated_pod_idx=np.full(G, -1, dtype=np.int32),
        pod_priority=pods((), 0, 10, np.int32),
        extender_mask=None,
        extender_score=None,
        dra_score_raw=rng.integers(0, 9, (2, N)).astype(np.int64),
        dra_score_sig=pods((), 0, 2, np.int32),
        podaffinity=SimpleNamespace(
            node_domain=rng.integers(-1, DA, (RA, N)).astype(np.int32),
            has_key=rng.random((RA, N)) < 0.9,
            base_sums=rng.integers(0, 3, (RA, DA)).astype(np.int64),
            update=pods((RA,), 0, 2, np.int64),
            fa_rows=pods((2,), -1, RA, np.int32),
            fa_self=pods((), 0, 2, bool),
            ra_rows=pods((2,), -1, RA, np.int32),
            ea_rows=pods((2,), -1, RA, np.int32),
            score_rows=pods((2,), -1, RA, np.int32),
            score_vals=pods((2,), -5, 5, np.int64),
            has_filter_work=True, has_score_work=True,
        ),
        spread=SimpleNamespace(
            eligible=rng.random((SP, N)) < 0.9,
            node_domain=rng.integers(-1, DS, (SP, N)).astype(np.int32),
            node_count=rng.integers(0, 4, (SP, N)).astype(np.int32),
            has_key=rng.random((SP, N)) < 0.9,
            domain_present=np.ones((SP, DS), dtype=bool),
            num_domains=np.full(SP, DS, dtype=np.int32),
            is_hostname=np.array([False, True]),
            sig_idx=pods((CSP,), -1, SP, np.int32),
            action=pods((CSP,), 0, 2, np.int8),
            max_skew=pods((CSP,), 1, 4, np.int32),
            min_domains=pods((CSP,), 1, 3, np.int32),
            self_match=pods((CSP,), 0, 2, np.int32),
            pod_match_sig=pods((SP,), 0, 2, bool),
            ignored=pods((N,), 0, 2, bool),
            template_id=np.zeros(P, dtype=np.int64),
            has_hard=True, has_soft=True,
        ),
        topology=None,
    )
    return leaves


def _all_weights() -> prt.ScoreParams:
    """Every weight and filter on, so that every sig leaf is packed."""
    return prt.ScoreParams(
        fit_weights=(1,) * R, balanced_weights=(1,) * R, is_scalar=(False,) * R,
        strategy=KC.LEAST_ALLOCATED, shape_x=(0, 100), shape_y=(0, 100), w_fit=1,
        w_balanced=1, w_node_affinity=2, w_taint=3, w_image=1, w_spread=2, w_interpod=2,
        w_dra=1, filter_fit=True, filter_ports=True, filter_spread=True,
        filter_interpod=True)


def test_key_lists_every_pod_leaf_the_kernel_packs(monkeypatch):
    """Every (P, ·) tensor that ``_score_args`` packs into the kernel's
    struct is in the key, and nothing else is: a pod-indexed leaf added to
    the struct later and left out of the key fails here."""
    for ext in (False, True):
        leaves = _synthetic(np.random.default_rng(0), same_pods=False)
        if ext:
            leaves["extender_mask"] = np.ones((P, N), dtype=bool)
            leaves["extender_score"] = np.zeros((P, N), dtype=np.int64)
        b = prt.device_batch_from_numpy(leaves, "cpu")
        seen = {}

        def check(name, x, dtype, shape, device, seen=seen):
            assert tuple(x.shape) == tuple(shape), name
            seen[name] = tuple(shape)
            return 0

        monkeypatch.setattr(kernels, "_check", check)
        monkeypatch.setattr(kernels, "_require_cuda", lambda dev, where: None)
        kernels._score_args(b, _all_weights(), "test")
        packed = {name.replace("pa.", "podaffinity.").replace("sp.", "spread.")
                  for name, shape in seen.items() if shape and shape[0] == P}
        want = set(prt.POD_CLASS_KEY)
        if not ext:
            want -= {"extender_mask", "extender_score"}
        assert packed == want
        # the batch dataclasses' other pod-indexed leaves are not packed
        pod_leaves = {f for f in prt.POD_FIELDS if M.pod_axis(f) == 0} | {
            f"{name}.{k}" for name in ("podaffinity", "spread")
            for k in prt.NESTED[name][1] if M.pod_axis(k, name) == 0}
        assert pod_leaves - set(prt.POD_CLASS_KEY) == {"pod_priority"}


def _bump(a: np.ndarray, row: int, path: str) -> None:
    """Change pod ``row``'s row of leaf ``a`` in place."""
    if a.dtype == bool:
        a[row] = ~a[row]
    elif path.endswith("_sig"):
        a[row] = (a[row] + 1) % 2
    else:
        a[row] = a[row] + 1


def _get(leaves, path):
    parent, _, field = path.rpartition(".")
    return leaves[field] if not parent else getattr(leaves[parent], field)


@pytest.mark.parametrize("path", prt.POD_CLASS_KEY)
def test_each_leaf_splits_a_class(path):
    """Pods equal in every leaf share one class; pod 3 changed in ``path``
    alone gets a class of its own (the extender leaves: every pod does)."""
    leaves = _synthetic(np.random.default_rng(1))
    classes = prt.pod_classes_of(leaves)
    assert classes.count == 1 and list(classes.members) == list(range(P))
    if path.startswith("extender_"):
        leaves["extender_mask"] = np.ones((P, N), dtype=bool)
        leaves["extender_score"] = np.zeros((P, N), dtype=np.int64)
        leaves[path][3, 0] ^= 1
        assert prt.pod_classes_of(leaves) is None
        b = prt.device_batch_from_numpy(leaves, "cpu")
        assert prt.pod_classes(b) is None
        return
    _bump(_get(leaves, path), 3, path)
    if path == "spread.ignored":
        # the encoder builds the row from the pod's template id
        leaves["spread"].template_id[3] = 1
    classes = prt.pod_classes_of(leaves)
    assert classes.count == 2
    assert list(classes.class_of) == [0, 0, 0, 1, 0, 0, 0]
    assert list(classes.class_start) == [0, 6, 7]
    assert list(classes.members) == [0, 1, 2, 4, 5, 6, 3]
    assert list(classes.host_rep_of()) == [0, 0, 0, 3, 0, 0, 0]
    b = prt.device_batch_from_numpy(leaves, "cpu")
    got = prt.pod_classes(b)
    assert got.count == 2 and got.rep_of.tolist() == [0, 0, 0, 3, 0, 0, 0]
    assert got.reps.tolist() == [0, 3]


def test_ignored_rows_without_template_ids_compare_whole():
    """A spread leaf without template ids (kubetpu's) is keyed by its rows."""
    leaves = _synthetic(np.random.default_rng(2))
    leaves["spread"].template_id = None
    assert prt.pod_classes_of(leaves).count == 1
    leaves["spread"].ignored[5, 4] ^= True
    assert list(prt.pod_classes_of(leaves).class_of) == [0, 0, 0, 0, 0, 1, 0]


def test_derived_batches_carry_classes_only_where_exact():
    """A replace (which may change a key leaf) drops the classes, a change
    of node rows keeps them, a pod row of a grid gets its own."""
    leaves = _synthetic(np.random.default_rng(3))
    _bump(leaves["requests"], 2, "requests")
    b = prt.device_batch_from_numpy(leaves, "cpu")
    assert prt.pod_classes(b).count == 2
    assert prt.pod_classes(dataclasses.replace(b, requests=b.requests.clone())) is None
    kept = prt.with_nodes(b, dataclasses.replace(b.nodes, node_valid=b.node_valid.clone()))
    assert prt.pod_classes(kept) is prt.pod_classes(b)
    rows = prt.pod_classes(b).rows(2, 6)
    assert list(rows.class_of) == [0, 1, 1, 1] and list(rows.members) == [0, 1, 2, 3]


# ---------------------------------------------- class-wise against kubetpu

ZONES = ("zone1", "zone2", "zone3")


def _workload(node_tmpl, bound_tmpl, pending_tmpl, n_nodes=40, n_bound=30, n_pending=24,
              zones=ZONES):
    cache = Cache()
    nodes = [KW.node_default(i, zones) for i in range(n_nodes)]
    for n in nodes:
        cache.add_node(n)
    for j in range(n_bound if bound_tmpl else 0):
        cache.add_pod(bound_tmpl(f"init-{j}", "namespace-0").with_node(
            nodes[j % n_nodes].name))
    pending = [pending_tmpl(f"m-{j}", "namespace-1") for j in range(n_pending)]
    return cache, pending


def _preemption():
    """PreemptionAsync's templates: four low-priority pods fill each node,
    the high-priority pods must preempt; some of them carry nominations."""
    cache, pending = _workload(KW.node_default, None, KW.pod_high_priority_3cpu, n_nodes=12,
                               n_pending=16)
    for j in range(48):
        cache.add_pod(KW.pod_low_priority(f"low-{j}", "namespace-0").with_node(
            f"scheduler-perf-{j % 12}"))
    nom = Nominator()
    for j in (1, 4, 9):
        nom.add(pending[j], f"scheduler-perf-{j}")
    return cache, pending, nom.entries()


CASES = {
    "basic": lambda: (*basic_cluster(num_nodes=40, num_bound=30, num_pending=24), ()),
    "podaffinity": lambda: (*_workload(KW.node_default, KW.pod_with_pod_affinity,
                                       KW.pod_with_pod_affinity), ()),
    "topologyspreading": lambda: (*_workload(KW.node_default, KW.pod_default,
                                             KW.pod_with_topology_spreading), ()),
    "preferred": lambda: (*_workload(KW.node_default, KW.pod_default,
                                     KW.pod_with_preferred_topology_spreading), ()),
    "binpacking": lambda: (*_workload(KW.node_default, None, KW.pod_binpack, n_pending=30),
                           ()),
    "preemption": _preemption,
}
# the real pods' classes in each case (the pads add one); each pod with a
# nomination of its own is a class (its gate row leaves its nomination out)
CLASSES = {"basic": 1, "podaffinity": 1, "topologyspreading": 1, "preferred": 1,
           "binpacking": 4, "preemption": 1 + 3}


def _select(b: prt.DeviceBatch, idx: torch.Tensor) -> prt.DeviceBatch:
    """The pods ``idx`` of ``b``: every pod-axis leaf's rows."""
    def take(x, axis):
        return x if x is None or axis != 0 else x.index_select(0, idx)

    leaves = {}
    for f in prt.POD_FIELDS:
        v = getattr(b, f)
        if f in ("spread", "podaffinity") and v is not None:
            leaves[f] = dataclasses.replace(v, **{
                k: take(getattr(v, k), M.pod_axis(k, f)) for k in prt.NESTED[f][1]})
        elif isinstance(v, torch.Tensor):
            leaves[f] = take(v, M.pod_axis(f))
    return dataclasses.replace(b, **leaves)


def classwise(b: prt.DeviceBatch, p: prt.ScoreParams):
    """The plain pair and normalize passes on each class's first pod, their
    rows copied to the class's pods (every pod its own class without
    classes)."""
    classes = prt.pod_classes(b)
    if classes is None:
        return prt.feasible_and_scores(b, p)
    reps = torch.from_numpy(classes.host_reps()).long()
    mask, total = prt.feasible_and_scores(_select(b, reps), p)
    idx = torch.from_numpy(classes.class_of).long()
    return mask[idx], total[idx]


def _equal(got, want) -> None:
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_classwise_plain_equals_kubetpu(case):
    cache, pending, nominated = CASES[case]()
    profile = KC.Profile()
    kb = krt.encode_batch(cache.update_snapshot(), pending, profile, nominated=nominated)
    kp = krt.score_params(profile, kb.resource_names)
    want = krt.feasible_and_scores(kb.device, kp)
    pp = port_params(kp)
    # kubetpu's leaves carried across (the spread's ignored rows compared
    # whole), and the port's own encode (keyed by template id)
    carried = port_batch_from_jax(kb.device)
    batches = [carried]
    if not nominated:
        batches.append(prt.encode_batch(
            port_cache(cache).update_snapshot(), [to_port(p) for p in pending],
            to_port(profile), device="cpu").device)
    for b in batches:
        classes = prt.pod_classes(b)
        pads = int(b.requests.shape[0]) > len(pending)
        assert classes.count == CLASSES[case] + pads
        _equal(classwise(b, pp), want)
        _equal(prt.feasible_and_scores(b, pp), want)


def test_classwise_plain_equals_kubetpu_on_the_webhook_batch():
    kd, kp, pd, pp = extender_pair("basic", 0)
    assert prt.pod_classes(pd) is None
    want = krt.feasible_and_scores(kd, kp)
    _equal(classwise(pd, pp), want)


@pytest.mark.parametrize("kind", ["prioritized", "mixed"])
def test_classwise_plain_equals_kubetpu_on_dra_prioritized_lists(kind):
    kd, kp, pd, pp = dra_batches(kind, 0)
    assert prt.pod_classes(pd).shared
    _equal(classwise(pd, pp), krt.feasible_and_scores(kd, kp))
