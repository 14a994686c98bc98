"""The port's node-axis mesh equals kubetpu's, bit for bit.

Counterparts of ``tests/test_mesh.py``'s 1-D and multislice tests: the
sharding rules, greedy and batched parity (assignments and the seven-slot
final state) for seeds 0-2, the one-shot Filter + Score, and batches with
no quadratic work. The port shards over G in {2, 4, 8} ``cpu`` devices
(``parallel.mesh.NodeMesh``); kubetpu over its 8 virtual CPU devices
(``tests/conftest.py``). Each batch is kubetpu's, carried across as numpy
leaves; each side runs its sharded engine, and both must also equal
kubetpu's unsharded engine. Plus: a batch whose best score ties across a
shard boundary (the first maximum must stay in the earlier shard), the
plain versions' explicit reductions. (The pods x nodes grid and the packing
engine on the mesh: ``test_torch_mesh2d.py``, ``test_torch_packing_mesh.py``.)
"""

import numpy as np
import pytest
import torch

import jax

from kubetpu.assign.batched import batched_assign_device as k_batched
from kubetpu.assign.greedy import greedy_assign_device as k_greedy
from kubetpu.framework import config as KC
from kubetpu.framework import encode_batch, score_params
from kubetpu.framework import runtime as krt
from kubetpu.parallel import make_mesh as k_make_mesh
from kubetpu.parallel import sharded_batched as k_sharded_batched
from kubetpu.parallel import sharded_greedy as k_sharded_greedy

from kubetpu_torch.parallel import mesh as M

from .cluster_gen import random_cluster
from .test_mesh import _build
from .torch_port_util import port_batch_from_jax, port_params

GS = [2, 4, 8]


@pytest.fixture(scope="module")
def kmesh():
    return k_make_mesh(jax.devices()[:8])


def cpu_mesh(g):
    return M.make_mesh(["cpu"] * g)


def _host(x):
    """numpy of a port tensor, a port ShardedTensor or a jax array."""
    if x is None:
        return None
    if isinstance(x, M.ShardedTensor):
        x = x.cpu()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_result(want, got):
    ka, kst = want
    pa, pst = got
    assert np.array_equal(_host(pa), np.asarray(ka))
    for k, (w, g) in enumerate(zip(kst, pst)):
        if w is None:
            assert g is None, k
            continue
        h = _host(g)
        assert h.dtype == np.asarray(w).dtype and np.array_equal(h, np.asarray(w)), k


def test_shard_rules_cut_every_node_leaf():
    """Every (..., N) leaf is cut on its node axis, per-pod leaves are
    replicated, nominated nodes are local, and static flags survive."""
    batch, _ = _build(seed=7)
    b = port_batch_from_jax(batch.device)
    assert b.spread is not None and b.podaffinity is not None
    n = b.alloc.shape[0]
    sb = M.shard_batch(b, cpu_mesh(8))
    assert sb.offsets == tuple(range(0, n, n // 8))
    for s, off in zip(sb.shards, sb.offsets):
        assert s.alloc.shape[0] == n // 8
        assert torch.equal(s.alloc, b.alloc[off:off + n // 8])
        for name in ("eligible", "node_domain", "node_count", "has_key", "ignored"):
            leaf = getattr(s.spread, name)
            assert leaf.shape[-1] == n // 8, name
            assert torch.equal(leaf, getattr(b.spread, name)[..., off:off + n // 8])
        for name in ("node_domain", "has_key"):
            assert getattr(s.podaffinity, name).shape[-1] == n // 8
        assert torch.equal(s.spread.sig_idx, b.spread.sig_idx)
        assert torch.equal(s.requests, b.requests)
        assert s.spread.has_hard == b.spread.has_hard
        assert s.podaffinity.has_filter_work == b.podaffinity.has_filter_work
    with pytest.raises(AttributeError, match="node-sharded"):
        sb.alloc
    assert torch.equal(sb.requests, b.requests)


def test_shard_rules_guard_degrades_to_one_shard():
    batch, _ = _build(seed=7)
    b = port_batch_from_jax(batch.device)
    mesh = M.NodeMesh(("cpu",) * 3)
    with pytest.raises(ValueError, match="do not split"):
        M.shard_batch(b, mesh)
    sb = M.shard_batch(b, mesh, guard=True)
    assert len(sb.shards) == 1 and sb.shards[0].alloc.shape == b.alloc.shape


def test_nominated_nodes_are_local_rows():
    b = port_batch_from_jax(_build(seed=7)[0].device)
    import dataclasses

    n = b.alloc.shape[0]
    nom = torch.tensor([0, n // 2, n - 1, -1], dtype=torch.int32)
    b = dataclasses.replace(b, nominated_node=nom)
    sb = M.shard_batch(b, cpu_mesh(2))
    assert sb.shards[0].nominated_node.tolist() == [0, -1, -1, -1]
    assert sb.shards[1].nominated_node.tolist() == [-1, 0, n // 2 - 1, -1]
    assert torch.equal(sb.nominated_node, nom)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_greedy_exact_parity(kmesh, seed, g):
    batch, params = _build(seed=seed)
    want = k_greedy(batch.device, params)
    _assert_result(want, k_sharded_greedy(batch.device, params, kmesh))
    got = M.sharded_greedy(port_batch_from_jax(batch.device), port_params(params),
                           cpu_mesh(g))
    _assert_result(want, got)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_batched_exact_parity(kmesh, seed, g):
    batch, params = _build(seed=seed)
    want = k_batched(batch.device, params)
    _assert_result(want, k_sharded_batched(batch.device, params, kmesh))
    got = M.sharded_batched(port_batch_from_jax(batch.device), port_params(params),
                            cpu_mesh(g))
    _assert_result(want, got)


@pytest.mark.parametrize("g", GS)
def test_sharded_one_shot_filter_score_parity(kmesh, g):
    """filter_score_batch (the extender Prioritize path) over the shards:
    each shard's rows of the mask and the total."""
    batch, params = _build(seed=5)
    ref_mask, ref_total = krt.filter_score_batch(batch.device, params)
    sb = M.shard_batch(port_batch_from_jax(batch.device), cpu_mesh(g))
    from kubetpu_torch.framework import runtime as prt

    mask, total = prt.filter_score_batch(sb, port_params(params))
    assert np.array_equal(mask.cpu().numpy(), np.asarray(ref_mask))
    assert np.array_equal(total.cpu().numpy(), np.asarray(ref_total))


def _minimal(seed, nodes, pods):
    rng = np.random.default_rng(seed)
    cache, pending = random_cluster(rng, num_nodes=nodes, num_pending=pods)
    profile = KC.minimal_profile()
    batch = encode_batch(cache.update_snapshot(), pending, profile)
    return batch, score_params(profile, batch.resource_names)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_sharded_no_quadratic_work(kmesh, engine, g):
    """Sharding holds when the spread and affinity leaves are None."""
    batch, params = _minimal(11 if engine == "greedy" else 13, 24, 12)
    kfn = k_greedy if engine == "greedy" else k_batched
    pfn = M.sharded_greedy if engine == "greedy" else M.sharded_batched
    want = kfn(batch.device, params)
    got = pfn(port_batch_from_jax(batch.device), port_params(params), cpu_mesh(g))
    _assert_result(want, got)


@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_multislice_hierarchical_node_shard_parity(engine):
    """The multislice mesh (2 slices x 4) shards the node dimension over
    both axes: the same 8 contiguous blocks, the same assignments."""
    from kubetpu.parallel import make_multislice_mesh

    batch, params = _build(seed=3)
    kfn = k_greedy if engine == "greedy" else k_batched
    ksh = k_sharded_greedy if engine == "greedy" else k_sharded_batched
    want = kfn(batch.device, params)
    kms = make_multislice_mesh(jax.devices()[:8], slices=2)
    assert np.array_equal(np.asarray(ksh(batch.device, params, kms)[0]), np.asarray(want[0]))
    pms = M.make_multislice_mesh(["cpu"] * 8, slices=2)
    assert pms.shape == (2, 4) and pms.axis_names == ("dcn", "nodes")
    assert M.node_axes_of(pms) == (("dcn", "nodes"), None)
    assert M.node_pad_multiple(pms) == 8
    pfn = M.sharded_greedy if engine == "greedy" else M.sharded_batched
    got = pfn(port_batch_from_jax(batch.device), port_params(params), pms)
    _assert_result(want, got)
    sb = M.shard_batch(port_batch_from_jax(batch.device), pms)
    assert len(sb.shards) == 8


def _tie_batch(nodes=16):
    """Identical empty nodes and pods: every step's best ties over all
    nodes, so every shard offers a candidate at the same score."""
    from kubetpu.api.wrappers import make_node, make_pod
    from kubetpu.state.snapshot import Cache

    cache = Cache()
    for i in range(nodes):
        cache.add_node(make_node(f"n-{i}", cpu_milli=1000, memory=8 * 1024**3))
    pending = [make_pod(f"p-{j}", cpu_milli=600, memory=128 * 1024**2,
                        creation_index=j) for j in range(nodes + 4)]
    profile = KC.Profile()
    batch = encode_batch(cache.update_snapshot(), pending, profile)
    return batch, score_params(profile, batch.resource_names)


@pytest.mark.parametrize("g", GS)
@pytest.mark.parametrize("engine", ["greedy", "batched"])
def test_tie_across_shards_keeps_the_first_maximum(engine, g):
    """The best score ties on every shard at every step; a pick that let a
    later shard win a tie would fill the nodes in another order."""
    batch, params = _tie_batch()
    kfn = k_greedy if engine == "greedy" else k_batched
    pfn = M.sharded_greedy if engine == "greedy" else M.sharded_batched
    want = kfn(batch.device, params)
    got = pfn(port_batch_from_jax(batch.device), port_params(params), cpu_mesh(g))
    _assert_result(want, got)
    if engine == "greedy":
        a = got[0].numpy()[:16]
        assert a.tolist() == list(range(16))   # node 0 first: shard 0 wins the tie


def test_first_best_breaks_ties_by_global_index():
    assert M.first_best([((5,), 3), ((5,), 9), ((4,), 12)]) == 3
    assert M.first_best([((5,), -1), ((5,), 9), ((6,), 12)]) == 12
    assert M.first_best([((), -1), ((), -1)]) == -1
    # the dry run's five keys
    assert M.first_best([((0, -1), 3), ((0, -1), 9)]) == 3
    assert M.first_best([((), -1), ((0, -1), 9), ((0, 0), 12)]) == 12


def test_run_sharded_reduces_every_point():
    """run_sharded combines each point's partials before any shard
    goes on: a two-point computation (a max, then a sum that reads it)."""
    def steps(x):
        mx = yield ("max", x.max())
        total = yield ("sum", (x == mx).sum())
        return mx, total

    xs = [torch.tensor([1, 7, 3]), torch.tensor([7, 2, 7])]
    got = M.run_sharded([steps(x) for x in xs], cpu_mesh(2))
    assert [(int(a), int(b)) for a, b in got] == [(7, 3), (7, 3)]


def test_resolve_mesh_on_one_cpu_device():
    assert M.resolve_mesh(None) is None and M.resolve_mesh("off") is None
    assert M.resolve_mesh("auto", device="cpu") is None
    with pytest.raises(ValueError, match="only 1"):
        M.resolve_mesh("on", device="cpu")
    mesh = cpu_mesh(4)
    assert M.resolve_mesh(mesh) is mesh
    with pytest.raises(ValueError, match="unknown mesh"):
        M.resolve_mesh("sideways")


def test_pod_scan_collective_ok_and_probe():
    for g in GS:
        assert M.pod_scan_collective_ok(cpu_mesh(g))
        assert M.measure_collective_wall(cpu_mesh(g), n=1 << 10) >= 0.0
    assert M.shard_argmax_plain([torch.tensor([1, 9]), torch.tensor([9, 3])]) == 1


def test_node_state_shardings_place_contiguous_rows():
    placed = M.node_state_shardings(cpu_mesh(4), 16)
    assert [s for _, s in placed] == [slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
