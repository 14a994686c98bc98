"""The explain on pod classes (B10) and the resident block's scatter plan
(B5), held to kubetpu on the CPU.

- ``explain_summary_tiled_plain``, the plain mirror of the
  ``explain_summary`` kernel's decomposition (class rows, one partial a
  (class, node tile), the partials merged in tile order, each pod its
  class's summary), equals kubetpu's ``_explain_kernel`` and
  ``explain_summary_plain`` exactly at tile widths 1, 7, 64 and N: feasible
  and rejection counts, the top 3 with its (-2^62, 0) pads, and ``win``.
  Batches: SchedulingBasic (one template), a mix of templates, the
  extender batch (a class a pod), a saturated batch (rows with 0, 1 and 2
  feasible nodes), equal top scores on both sides of a tile boundary,
  nominations; assignments that hold -1, and all -1.
- ``ScatterPlan``: the plan of a replaced block raises and writes nothing;
  the plan-driven scatter of a refresh's delta, of a delta with pads at and
  past N, and of each shard's routed delta (shard-local indices) equals
  kubetpu's ``_scatter_node_rows`` on the same rows.

Tolerance: exact throughout.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest

import kubetpu  # noqa: F401
from kubetpu.api.wrappers import make_node, make_pod
from kubetpu.framework import config as KC
from kubetpu.framework import runtime as krt
from kubetpu.perf import workloads as KW
from kubetpu.sched import flightrecorder as KFR
from kubetpu.state.snapshot import Cache

from kubetpu_torch.framework import runtime as prt
from kubetpu_torch.parallel import mesh as M
from kubetpu_torch.sched import flightrecorder as PFR

from .test_torch_extender import extender_pair
from .test_torch_nominations import nominated_cluster
from .torch_port_util import port_batch_from_jax, port_params

# ------------------------------------------------------- B10 on pod classes


def _basic(rng):
    """SchedulingBasic: one template, every node scoring the same."""
    nodes = [KW.node_default(i) for i in range(40)]
    pods = [KW.pod_default(f"m-{j}", "ns") for j in range(24)]
    return nodes, pods, ()


def _mixed(rng):
    """Four templates taking turns, on nodes of three sizes."""
    nodes = [make_node(f"n{i}", cpu_milli=2000 * (1 + i % 3), memory=(4 + i % 5) * 2**30)
             for i in range(48)]
    sizes = [(100, 2**27), (900, 2**29), (2500, 2**30), (5000, 2**31)]
    pods = [make_pod(f"p{j}", cpu_milli=sizes[j % 4][0], memory=sizes[j % 4][1],
                     creation_index=j) for j in range(30)]
    return nodes, pods, ()


def _saturated(rng):
    """Pods whose requests fit on 0, 1, 2 or many of the nodes."""
    nodes = [make_node(f"n{i}", cpu_milli=1000 * (i + 1), memory=(i + 1) * 2**30, pods=4)
             for i in range(12)]
    pods = [make_pod(f"p{j}", cpu_milli=cpu, memory=2**28, creation_index=j)
            for j, cpu in enumerate([500, 9500, 10500, 11500, 20000] * 4)]
    return nodes, pods, ()


def _boundary(rng):
    """Only nodes 6, 7, 13 and 14 pass the pods' selector, all scoring the
    same: at tile width 7 the top scores tie across two tile boundaries."""
    nodes = [make_node(f"n{i:02d}", labels={"pick": "yes"} if i in (6, 7, 13, 14) else {})
             for i in range(24)]
    pods = [make_pod(f"p{j}", cpu_milli=100, memory=2**27, node_selector={"pick": "yes"},
                     creation_index=j) for j in range(10)]
    return nodes, pods, ()


def _nominations(rng):
    cache, pending, nom = nominated_cluster(int(rng.integers(0, 100)))
    return cache, pending, nom.entries()


BATCHES = {"basic": _basic, "mixed": _mixed, "saturated": _saturated,
           "boundary": _boundary, "nominations": _nominations}


@functools.lru_cache(maxsize=None)
def _batch(case):
    """kubetpu's batch and params, the port's (CPU, with its pod classes)
    and params."""
    if case == "extender":
        return extender_pair("images", 0)
    out = BATCHES[case](np.random.default_rng(7))
    if isinstance(out[0], Cache):
        cache, pending, nominated = out
    else:
        nodes, pending, nominated = out
        cache = Cache()
        for n in nodes:
            cache.add_node(n)
    kb = krt.encode_batch(cache.update_snapshot(), pending, KC.Profile(), nominated=nominated)
    kp = krt.score_params(KC.Profile(), kb.resource_names)
    return kb.device, kp, port_batch_from_jax(kb.device), port_params(kp)


def _assignments(case, P, N, how):
    if how == "none":
        return np.full(P, -1, np.int32)
    rng = np.random.default_rng(len(case))
    idx = rng.integers(0, N, P).astype(np.int32)
    idx[rng.random(P) < 0.3] = -1
    return idx


@functools.lru_cache(maxsize=None)
def _reference(case, how):
    kdev, kp, pdev, _ = _batch(case)
    idx = _assignments(case, pdev.requests.shape[0], pdev.alloc.shape[0], how)
    return idx, KFR._explain_kernel(kdev, kp, jnp.asarray(idx))


def _flat(out):
    feasible, reject, top_vals, top_idx, win = out
    return [feasible, *reject, top_vals, top_idx, win]


def _equal(got, want):
    for i, (g, w) in enumerate(zip(_flat(got), _flat(want))):
        assert (g is None) == (w is None), i
        if g is None:
            continue
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.numpy().shape == w.shape, i
        assert np.array_equal(g.numpy(), w), i


CASES = sorted(BATCHES) + ["extender"]


@pytest.mark.parametrize("how", ["some", "none"])
@pytest.mark.parametrize("tile", [1, 7, 64, "N"])
@pytest.mark.parametrize("case", CASES)
def test_tiled_explain_equals_reference(case, tile, how):
    _, _, pdev, pp = _batch(case)
    idx, want = _reference(case, how)
    N = pdev.alloc.shape[0]
    got = PFR.explain_summary_tiled_plain(pdev, pp, idx, N if tile == "N" else tile)
    _equal(got, want)
    _equal(PFR.explain_summary_plain(pdev, pp, idx), want)


def test_the_batches_hold_their_edges():
    """Basic is one class of pods (and one of pads), the extender batch a
    class a pod, the saturated batch has rows with 0, 1 and 2 feasible
    nodes, and the boundary batch's top 3 ties across tile boundaries."""
    classes = {case: prt.pod_classes(_batch(case)[2]) for case in CASES}
    assert classes["basic"].count == 2 and classes["extender"] is None
    assert 4 <= classes["mixed"].count < _batch("mixed")[2].requests.shape[0]
    feasible = _reference("saturated", "some")[1][0]
    f = np.asarray(feasible)
    assert (f == 0).any() and (f == 1).any() and (f == 2).any()
    top = np.asarray(_reference("boundary", "some")[1][3])
    assert top[0].tolist() == [6, 7, 13]
    nom = _batch("nominations")[2]
    assert nom.nominated_node is not None


# ------------------------------------------------------ B5's scatter plan

R = 3


def _nt(rng, NC):
    """Node tensors of NC padded rows, as a resident block reads them."""
    return types.SimpleNamespace(
        alloc=rng.integers(0, 1 << 40, (NC, R)).astype(np.int64),
        requested=rng.integers(0, 1 << 40, (NC, R)).astype(np.int64),
        nonzero_requested=rng.integers(0, 1 << 40, (NC, R)).astype(np.int64),
        pod_count=rng.integers(0, 110, NC).astype(np.int32),
        allowed_pods=rng.integers(0, 111, NC).astype(np.int32),
        pending_device_rows=None)


def _block_numpy(nodes):
    return [getattr(nodes, n).numpy().copy() for n in prt.NODE_FIELDS]


def _kubetpu_scatter(block, delta):
    """kubetpu's _scatter_node_rows of ``delta`` (DELTA_FIELDS arrays) into
    the numpy ``block``."""
    out = krt._scatter_node_rows(*(jnp.asarray(a) for a in block),
                                 *(jnp.asarray(delta[n]) for n in prt.DELTA_FIELDS))
    return [np.asarray(a) for a in out]


def _dirty(rng, nt, rows):
    for name in ("alloc", "requested", "nonzero_requested", "pod_count", "allowed_pods"):
        a = getattr(nt, name)
        a[rows] = rng.integers(0, 1 << 30, a[rows].shape).astype(a.dtype)


def _assert_block(nodes, want):
    for name, w in zip(prt.NODE_FIELDS, want):
        got = getattr(nodes, name).numpy()
        assert got.dtype == w.dtype and np.array_equal(got, w), name


def test_stale_scatter_plan_raises_and_writes_nothing():
    rng = np.random.default_rng(0)
    nt = _nt(rng, 64)
    resident = prt.ResidentNodeState("cpu")
    resident._full_upload(nt, 60)
    plan = resident.plans[0]
    rows = [3, 9, 41]
    _dirty(rng, nt, rows)
    delta = prt.upload_packed(resident._delta(nt, rows, 60), "cpu")
    old_block = resident.device
    before = _block_numpy(old_block)
    resident._full_upload(_nt(rng, 64), 60)
    assert resident.plans[0] is not plan
    with pytest.raises(prt.StalePlan):
        plan.scatter(delta)
    _assert_block(old_block, before)
    resident.plans[0].scatter(delta)


@pytest.mark.parametrize("seed", range(3))
def test_plan_scatter_of_a_refresh_equals_kubetpu(seed):
    """The refresh's own delta (pads at the padded count) and one with pads
    past it, each through the block's plan."""
    rng = np.random.default_rng(seed)
    NC, n_real = 128, 120
    nt = _nt(rng, NC)
    resident = prt.ResidentNodeState("cpu")
    resident._full_upload(nt, n_real)
    rows = sorted(rng.choice(n_real, 13, replace=False).tolist())
    _dirty(rng, nt, rows)
    nt.pending_device_rows = set(rows)
    block = _block_numpy(resident.device)
    delta = resident.refresh(nt, n_real)
    assert delta is not None and len(delta["delta.idx"]) > len(rows)
    resident.scatter(prt.upload_packed(delta, "cpu"))
    block = _kubetpu_scatter(block, delta)
    _assert_block(resident.device, block)
    # pads past the padded count too, and rows in any order
    idx = np.concatenate([rng.permutation(n_real)[:5], [NC, NC + 3, NC + 40]]).astype(np.int32)
    updates = _nt(rng, len(idx))
    delta = dict(zip(prt.DELTA_FIELDS, (
        idx, updates.alloc, updates.requested, updates.nonzero_requested, updates.pod_count,
        updates.allowed_pods, rng.random(len(idx)) < 0.5)))
    resident.scatter(prt.upload_packed(delta, "cpu"))
    _assert_block(resident.device, _kubetpu_scatter(block, delta))


@pytest.mark.parametrize("seed", range(2))
def test_plan_scatter_of_routed_deltas_equals_kubetpu(seed):
    """Under a 4-shard mesh each shard's block has its own plan; each
    shard's routed delta (shard-local indices, pads at the shard's row
    count) equals kubetpu's scatter of the same arrays into that shard."""
    rng = np.random.default_rng(seed)
    NC, n_real = 256, 250
    nt = _nt(rng, NC)
    resident = prt.ResidentNodeState("cpu", mesh=M.make_mesh(["cpu"] * 4))
    resident._full_upload(nt, n_real)
    assert len(resident.plans) == 4
    rows = sorted(rng.choice(n_real, 20, replace=False).tolist())
    _dirty(rng, nt, rows)
    blocks = [_block_numpy(s) for s in resident.shards]
    routed = resident._routed(nt, rows, n_real)
    per = NC // 4
    assert routed is not None and len(routed) == 4
    for g, delta in enumerate(routed):
        mine = [r - g * per for r in rows if r // per == g]
        if not mine:
            assert delta is None
            continue
        idx = delta["delta.idx"]
        assert idx[:len(mine)].tolist() == mine and (idx[len(mine):] == per).all()
        resident.block(g).scatter(prt.upload_packed(delta, "cpu"))
        blocks[g] = _kubetpu_scatter(blocks[g], delta)
    for g, shard in enumerate(resident.shards):
        _assert_block(shard, blocks[g])
