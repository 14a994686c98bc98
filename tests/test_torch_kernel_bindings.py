"""The ctypes bindings of the port's kernels against the C signatures of
their sources.

The kernels build and run only on a CUDA card, but the ``argtypes`` the
wrappers declare for each ``extern "C"`` entry point can be held to the
source here: one ctypes type per parameter, in order (``int64_t`` ->
``c_int64``, ``int`` -> ``c_int``, any pointer -> ``c_void_p``). A
parameter missing from the list would shift every later one at the call.
"""

import ctypes
import re

import pytest

from kubetpu_torch import kernels

_SIG = re.compile(r'extern "C" int (kt_\w+)\(([^)]*)\)', re.S)


def _entry_points():
    out = {}
    for src in kernels.SOURCES:
        text = (kernels.CSRC / src).read_text()
        for name, params in _SIG.findall(text):
            out[name] = (src, [p.strip() for p in params.split(",")])
    return out


def _declared():
    out = {f"kt_{name}": types for name, types in kernels._ARGTYPES.items()}
    for entries in kernels._MORE_ENTRIES.values():
        out.update(entries)
    return out


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(" ", 1)[0].replace("const ", "").strip()
    return {"int64_t": ctypes.c_int64, "int": ctypes.c_int}[kind]


ENTRIES = _entry_points()


def test_every_entry_point_is_declared():
    assert set(ENTRIES) == set(_declared())


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_argtypes_match_the_source(name):
    src, params = ENTRIES[name]
    assert _declared()[name] == [_ctype(p) for p in params], src


# parameters added to existing entry points, each just before the stream:
# the pod classes of filter_score's two entries, and K4's host word pair
ADDED = {
    "kt_filter_score": ["const void* reps", "const void* rep_of", "int64_t C"],
    "kt_filter_score_shard": ["const void* reps", "const void* rep_of", "int64_t C"],
    "kt_shard_argmax": ["void* host_out"],
}


@pytest.mark.parametrize("name", sorted(ADDED))
def test_added_parameters_precede_the_stream(name):
    _, params = ENTRIES[name]
    assert params[-1] == "void* stream"
    assert params[-1 - len(ADDED[name]):-1] == ADDED[name]
    assert _declared()[name][-1 - len(ADDED[name]):] == [
        _ctype(p) for p in ADDED[name] + ["void* stream"]]


# ---- the greedy scan's block (csrc/scan_loop.cuh) ------------------------

_SCAN_SRC = (kernels.CSRC / "scan_loop.cuh").read_text()


def _constexpr(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _SCAN_SRC)
    assert m, name
    return int(m.group(1))


def test_scan_node_limit_matches_the_source():
    assert kernels.SCAN_THREADS == _constexpr("kThreads")
    assert kernels.SCAN_MAX_NODES == _constexpr("kThreads") * _constexpr("kPer")
    # the touched, kept-verdict and mask bits of a thread's nodes are one
    # 32-bit word each
    assert _constexpr("kPer") <= 32


def test_scan_smem_layout_matches_the_source():
    # the staged pod's words and the three stages the wrapper sizes
    assert "return 2 * R + 3 + (K + 7) / 8;" in _SCAN_SRC
    assert _constexpr("kStages") == 3
    # R = 3, K = 0, B = 2: the params table (13 words, to a 16-byte
    # boundary), then three pods of 2R + 3 words
    assert kernels.scan_smem_bytes(0, 3, 0, 2) == 112 + 8 * 3 * 9
    # the N base scores follow the stages
    assert (kernels.scan_smem_bytes(5120, 3, 0, 2)
            - kernels.scan_smem_bytes(0, 3, 0, 2)) == 8 * 5120
    # the spread region: a copy of the slot weights a warp, and two steps'
    # bitmaps of every slot while they take at most kFastBitmapBytes
    assert "constexpr int64_t kFastBitmapBytes = 32768;" in _SCAN_SRC
    assert kernels._FAST_BITMAP_BYTES == 32768
    warps = _constexpr("kThreads") // 32
    region = kernels.scan_smem_bytes(0, 3, 0, 2, (2, 100)) - kernels.scan_smem_bytes(0, 3, 0, 2)
    assert region == (8 * 2 * warps + 8 * 2 * 4 + 15) // 16 * 16
    # past kFastBitmapBytes one bitmap
    D = 32 * 4097
    region = kernels.scan_smem_bytes(0, 3, 0, 2, (1, D)) - kernels.scan_smem_bytes(0, 3, 0, 2)
    assert region == (8 * warps + 4 * 4097 + 15) // 16 * 16


# every path's node count a block scans: 500 nodes, a shard or tile of the
# 5000-node mesh and grid, the 5000- and 15000-node cases, and the limit
@pytest.mark.parametrize("N", [512, 1280, 2560, 5120, 15360, kernels.SCAN_MAX_NODES])
@pytest.mark.parametrize("R,K", [(3, 0), (4, 2), (8, 64)])
# no spread leaf; zones; hostname domains at N; the largest bitmap that
# stays in shared memory beside 8 slots' weights
@pytest.mark.parametrize("spread", [None, (2, 3), (2, 16384), (8, 32 * (10240 - 16))])
def test_scan_smem_fits_a_block(N, R, K, spread):
    smem = kernels.scan_smem_bytes(N, R, K, 2, spread)
    assert smem <= kernels.SHARED_MAX - kernels._SCAN_STATIC <= 232448


def test_scan_smem_of_a_spread_batch():
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt
    from kubetpu_torch.perf import workloads as W
    from kubetpu_torch.state.snapshot import Cache

    cache = Cache()
    for i in range(40):
        cache.add_node(W.node_default(i, zones=("zone-a", "zone-b", "zone-c")))
    pods = [W.pod_with_preferred_topology_spreading(f"p-{j}", "ns") for j in range(8)]
    batch = rt.encode_batch(cache.update_snapshot(), pods, C.Profile(), device="cpu")
    b = batch.device
    params = rt.score_params(C.Profile(), batch.resource_names)
    assert b.spread is not None and kernels._smem(b) > 0
    N, R = b.alloc.shape
    C, D = b.spread.sig_idx.shape[1], b.spread.domain_present.shape[1]
    assert kernels._scan_smem(b, params, "test") == kernels.scan_smem_bytes(
        N, R, b.port_conflict.shape[0], len(params.shape_x), (C, D))


def _wide_batch(N: int, K: int = 0):
    import torch
    from types import SimpleNamespace

    return SimpleNamespace(alloc=torch.zeros((N, 3), dtype=torch.int64),
                           port_conflict=torch.zeros((K, K), dtype=torch.bool), spread=None)


@pytest.mark.parametrize("entry", ["greedy_scan", "placement_scan"])
def test_scan_raises_beyond_its_block(entry):
    import torch
    from types import SimpleNamespace

    params = SimpleNamespace(shape_x=(0, 100))
    N = kernels.SCAN_MAX_NODES + 1024
    b = _wide_batch(N)
    with pytest.raises(ValueError, match="one scan block takes at most"):
        if entry == "greedy_scan":
            kernels.greedy_scan(b, params)
        else:
            kernels.placement_scan(b, params, torch.ones((2, N), dtype=torch.bool))


def test_scan_raises_beyond_a_blocks_shared_memory():
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="bytes of shared memory"):
        kernels._scan_smem(_wide_batch(1024, K=80000), SimpleNamespace(shape_x=(0, 100)), "t")
