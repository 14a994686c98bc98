#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of kubetpu (``kubetpu_torch``) on one NVIDIA
card and check it.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order (any failure raises: the exit code is then non-zero and the
final ``ok`` line is not printed):

1. device: requires CUDA, prints ``nvidia-smi``'s name and power limit;
2. build: compiles the kernels from ``kubetpu_torch/kernels/csrc`` with nvcc
   (one process per source, started together) and prints the build time
   and ptxas' register / spill report;
3. kernels vs plain: on seeded encoded batches — one SchedulingBasic cycle
   at 1024 pods × 5120 padded nodes, a mixed cluster (static masks, host
   ports, images, node-affinity preferences, taints, an extended
   resource) under all three scoring strategies, and a saturated batch —
   ``filter_score`` must equal the plain ``feasible_and_scores`` (mask and
   int64 total) and the ``greedy_scan`` engine must equal
   ``greedy_assign_plain`` (assignments and final node state) exactly, on
   CUDA tensors;
4. main path: ``run_workload("SchedulingBasic", "5000Nodes_10000Pods",
   device="cuda")`` with the launch counts reset just before and read just
   after; checks that all 11000 pods are bound, that no node exceeds its
   allocatable or its pod count, and that the first cycle's kernel
   assignments equal the plain greedy loop's on the same batch;
5. prints the kernels' JSON line, the card line, and the ``ok`` line last.

Tolerance everywhere: exact (integer masks, scores and assignments).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor FP64 rate, the
# rates the bounds below divide by
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------- 1. device
def device_phase() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return card


# -------------------------------------------------------------- 2. build
def build_phase() -> float:
    from kubetpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.1f} s")
    for src, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    return secs


# --------------------------------------------------- 3. kernels vs plain
def _cache_with(nodes, pods_bound):
    from kubetpu_torch.state.snapshot import Cache

    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in pods_bound:
        cache.add_pod(p)
    return cache


def basic_case(n_nodes=5000, n_bound=1000, n_pending=1024):
    """A SchedulingBasic cycle: node_default nodes, pod_default pods (the
    init pods already bound round-robin), a full batch pending."""
    from kubetpu_torch.perf import workloads as W

    nodes = [W.node_default(i) for i in range(n_nodes)]
    bound = [
        W.pod_default(f"init-{j}", "namespace-0").with_node(nodes[j % n_nodes].name)
        for j in range(n_bound)
    ]
    pending = [W.pod_default(f"measure-{j}", "namespace-1") for j in range(n_pending)]
    return _cache_with(nodes, bound), pending


def mixed_case(seed=0, n_nodes=2000, n_bound=3000, n_pending=512):
    """A seeded cluster that exercises every leaf the kernels take: static
    masks (node selectors, NoSchedule taints, unschedulable nodes), host
    ports, an extended resource, images, preferred node affinity and
    PreferNoSchedule taints."""
    import numpy as np

    from kubetpu_torch.api import types as t
    from kubetpu_torch.api.wrappers import make_node, make_pod

    rng = np.random.default_rng(seed)
    images = [f"img-{i}" for i in range(6)]
    nodes = []
    for i in range(n_nodes):
        labels = {"kubernetes.io/hostname": f"node-{i}",
                  "zone": f"z{i % 3}"}
        if rng.random() < 0.3:
            labels["disktype"] = str(rng.choice(["ssd", "hdd"]))
        taints = ()
        if rng.random() < 0.25:
            effect = rng.choice([t.TaintEffect.NO_SCHEDULE, t.TaintEffect.PREFER_NO_SCHEDULE])
            taints = (t.Taint(key="dedicated", value="gpu", effect=effect),)
        node_images = {
            im: t.ImageState(size_bytes=int(rng.integers(10, 900)) * 1024**2,
                             num_nodes=int(rng.integers(1, n_nodes)))
            for im in images if rng.random() < 0.3
        }
        nodes.append(make_node(
            f"node-{i}", cpu_milli=int(rng.integers(1000, 16001)),
            memory=int(rng.integers(2, 64)) * 1024**3,
            pods=int(rng.integers(4, 110)), labels=labels, taints=taints,
            extended={"example.com/foo": int(rng.integers(0, 8))},
            unschedulable=bool(rng.random() < 0.05), images=node_images,
        ))
    bound = []
    for j in range(n_bound):
        node = nodes[int(rng.integers(0, n_nodes))]
        bound.append(make_pod(
            f"existing-{j}", cpu_milli=int(rng.integers(0, 1001)),
            memory=int(rng.integers(0, 4)) * 256 * 1024**2, node_name=node.name,
            host_ports=[int(rng.integers(8000, 8004))] if rng.random() < 0.2 else [],
        ))
    pending = []
    for j in range(n_pending):
        kw = {}
        if rng.random() < 0.3:
            kw["node_selector"] = {"disktype": "ssd"}
        if rng.random() < 0.5:
            kw["tolerations"] = [t.Toleration(
                key="dedicated", operator=t.TolerationOperator.EQUAL,
                value="gpu", effect=None)]
        if rng.random() < 0.4:
            kw["affinity"] = t.Affinity(node_affinity=t.NodeAffinity(preferred=(
                t.PreferredSchedulingTerm(int(rng.integers(1, 100)), t.NodeSelectorTerm(
                    (t.Requirement("zone", t.Operator.IN, (f"z{int(rng.integers(0, 3))}",)),))),
            )))
        if rng.random() < 0.5:
            kw["images"] = [str(im) for im in rng.choice(images, size=2, replace=False)]
        req = {}
        if rng.random() < 0.9:
            req[t.CPU] = int(rng.integers(0, 3001))
        if rng.random() < 0.9:
            req[t.MEMORY] = int(rng.integers(0, 8)) * 256 * 1024**2
        if rng.random() < 0.4:
            req["example.com/foo"] = int(rng.integers(1, 4))
        pending.append(make_pod(
            f"pending-{j}", requests=req, creation_index=j,
            host_ports=[int(rng.integers(8000, 8004))] if rng.random() < 0.2 else [],
            **kw,
        ))
    return _cache_with(nodes, bound), pending


def saturated_case(n_nodes=64, n_pending=512):
    """More pods than capacity: most of the batch ends unschedulable (-1)."""
    from kubetpu_torch.api.wrappers import make_node, make_pod

    nodes = [make_node(f"small-{i}", cpu_milli=1000, memory=4 * 1024**3, pods=10)
             for i in range(n_nodes)]
    pending = [make_pod(f"p-{j}", cpu_milli=300, memory=256 * 1024**2)
               for j in range(n_pending)]
    return _cache_with(nodes, []), pending


def profiles():
    from kubetpu_torch.framework import config as C

    return {
        "least": C.Profile(),
        "most": C.Profile(scoring_strategy=C.ScoringStrategy(type=C.MOST_ALLOCATED)),
        "rtcr": C.Profile(scoring_strategy=C.ScoringStrategy(
            type=C.REQUESTED_TO_CAPACITY_RATIO,
            shape=((0, 0), (40, 8), (100, 3)))),  # a decreasing segment
        # three balanced resources: the population-std branch (sqrt)
        "balanced3": C.Profile(balanced_resources=(
            ("cpu", 1), ("memory", 1), ("example.com/foo", 1))),
    }


def encode(cache, pending, profile):
    from kubetpu_torch.framework import runtime as rt

    snap = cache.update_snapshot()
    batch = rt.encode_batch(snap, pending, profile, device="cuda")
    return batch.device, rt.score_params(profile, batch.resource_names)


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each timed with CUDA events
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def f64_ops_per_pair(params) -> int:
    """float64 operations of the balanced score for one (pod, node) pair:
    per side, each present resource costs a divide, a min, an add, a
    subtract, a multiply, an abs and two adds; then a mean divide, the std
    divide or sqrt, and the final subtract and multiply."""
    n_bal = sum(1 for w in params.balanced_weights if w > 0)
    return 2 * (8 * n_bal + 4) if params.w_balanced else 0


def _max_abs(a, b) -> int:
    import torch

    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def check_case(name, b, params, results):
    """Hold both kernels to their plain versions on one batch. Returns the
    largest absolute difference seen (0 when exact)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.framework import runtime as rt

    km, kt = kernels.filter_score(b, params)
    pm, pt = rt.feasible_and_scores(b, params)
    torch.cuda.synchronize()
    err_fs = max(_max_abs(km, pm), _max_abs(kt, pt))
    if not (torch.equal(km, pm) and torch.equal(kt, pt)):
        raise AssertionError(f"{name}: filter_score differs from the plain version "
                             f"(max abs err {err_fs})")
    ka, ks = kernels.greedy_scan(b, params)
    pa, ps = greedy_assign_plain(b, params)
    torch.cuda.synchronize()
    err_gs = _max_abs(ka, pa)
    for i in range(4):
        err_gs = max(err_gs, _max_abs(ks[i], ps[i]))
    if not torch.equal(ka, pa) or not all(torch.equal(ks[i], ps[i]) for i in range(4)):
        raise AssertionError(f"{name}: greedy_scan differs from greedy_assign_plain "
                             f"(max abs err {err_gs})")
    n_unsched = int((ka[: int(b.pod_valid.sum().item())] < 0).sum().item())
    log(f"kernels vs plain [{name}]: P={b.requests.shape[0]} N={b.alloc.shape[0]} "
        f"R={b.alloc.shape[1]} K={b.port_conflict.shape[0]} exact "
        f"(feasible pairs {int(km.sum().item())}, unschedulable {n_unsched})")
    results["filter_score"]["cases"].append(name)
    results["greedy_scan"]["cases"].append(name)
    results["filter_score"]["max_abs_err"] = max(results["filter_score"]["max_abs_err"], err_fs)
    results["greedy_scan"]["max_abs_err"] = max(results["greedy_scan"]["max_abs_err"], err_gs)
    return ka


def kernels_phase():
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.framework import runtime as rt

    results = {
        "filter_score": {"cases": [], "max_abs_err": 0},
        "greedy_scan": {"cases": [], "max_abs_err": 0},
    }
    # the SchedulingBasic cycle: the main path's shapes, and the timings
    cache, pending = basic_case()
    b, params = encode(cache, pending, C.Profile())
    ka = check_case("SchedulingBasic 1024x5120", b, params, results)
    for name, prof in profiles().items():
        cache_m, pending_m = mixed_case(seed=1)
        bm, pm = encode(cache_m, pending_m, prof)
        check_case(f"mixed/{name}", bm, pm, results)
    cache_s, pending_s = saturated_case()
    bs, ps = encode(cache_s, pending_s, C.Profile())
    check_case("saturated", bs, ps, results)

    P, N = b.requests.shape[0], b.alloc.shape[0]
    in_bytes = rt.batch_nbytes(b)
    state_bytes = sum(int(x.nbytes) for x in (b.requested, b.nonzero_requested,
                                              b.pod_count, b.node_ports))
    pair_ops = f64_ops_per_pair(params)
    # the greedy engine scores every pair once at the batch's start, and
    # each step again for the nodes earlier pods of the batch landed on
    a_host = ka.cpu().tolist()
    seen: set = set()
    rescored = 0
    for j in a_host:
        rescored += len(seen)
        if j >= 0:
            seen.add(j)
    timing = {
        "filter_score": {
            "ms": cuda_ms(lambda: kernels.filter_score(b, params), 20),
            "plain_ms": cuda_ms(lambda: rt.feasible_and_scores(b, params), 5),
            "bytes": in_bytes + P * N * (1 + 8),
            "ops": P * N * pair_ops,
        },
        "greedy_scan": {
            "ms": cuda_ms(lambda: kernels.greedy_scan(b, params), 10),
            "plain_ms": cuda_ms(lambda: greedy_assign_plain(b, params), 1),
            "bytes": in_bytes + P * 4 + state_bytes,
            "ops": (P * N + rescored) * pair_ops,
        },
    }
    out = []
    for name, src, replaces in (
        ("filter_score", "kubetpu_torch/kernels/csrc/filter_score.cu",
         "kubetpu/framework/runtime.py:1578"),
        ("greedy_scan", "kubetpu_torch/kernels/csrc/greedy_scan.cu",
         "kubetpu/assign/greedy.py:106"),
    ):
        tm = timing[name]
        bytes_ms = 1e3 * tm["bytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * tm["ops"] / FP64_FLOPS
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "result": "equal to the plain version",
            "max_abs_err": results[name]["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "cases": results[name]["cases"], "shape": [P, N],
        })
        log(f"timing [{name}] at P={P} N={N}: kernel {tm['ms']:.4f} ms, plain "
            f"{tm['plain_ms']:.4f} ms, bound {max(bytes_ms, ops_ms):.6f} ms")
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------- 4. main path
def main_path_phase(card: str) -> dict:
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.assign.greedy import greedy_assign_plain
    from kubetpu_torch.perf import run_workload

    captured: dict = {}

    def observe(sched):
        captured["sched"] = sched
        engine = sched._assign_device

        def first_cycle_recorder(b, params):
            out = engine(b, params)
            if "first" not in captured:
                captured["first"] = (b, params, out[0].clone())
            return out

        sched._assign_device = first_cycle_recorder

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_workload("SchedulingBasic", "5000Nodes_10000Pods", device="cuda",
                       on_scheduler=observe)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)

    sched = captured["sched"]
    expected = 1000 + 10000
    if res.bound_total != expected or res.scheduled != res.measure_pods:
        raise AssertionError(f"main path bound {res.bound_total} of {expected} pods")
    # capacity: every node's exact requests within allocatable, pods <= 110
    for info in sched.cache.update_snapshot().node_infos():
        alloc = dict(info.node.allocatable)
        for k, v in info.requested.items():
            if v > alloc.get(k, 0):
                raise AssertionError(f"{info.node.name}: {k} {v} > {alloc.get(k, 0)}")
        if len(info.pods) > alloc.get("pods", 0):
            raise AssertionError(f"{info.node.name}: {len(info.pods)} pods")
    b, params, first = captured["first"]
    plain, _ = greedy_assign_plain(b, params)
    torch.cuda.synchronize()
    if not torch.equal(first, plain):
        raise AssertionError("first cycle: kernel assignments differ from the plain greedy")
    for name in ("filter_score", "greedy_scan"):
        if launches[name] < 1:
            raise AssertionError(f"main path never launched {name}")
    line = {
        "main_path": {
            "workload": "SchedulingBasic/5000Nodes_10000Pods",
            "pods_bound": res.bound_total, "pods_per_s": res.throughput,
            "measured_pods": res.scheduled, "measured_s": res.duration_s,
            "cycles": res.cycles, "cycle_ms": res.cycle_ms,
            "upload_bytes_per_cycle": res.upload_bytes_per_cycle,
            "run_s": wall, "launches": launches, "first_cycle_equal": True,
            "card": card,
        }
    }
    log(json.dumps(line))
    return launches


def main() -> int:
    if not (ROOT / "kubetpu_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from the root of a kubetpu checkout "
                         "(kubetpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    card = device_phase()
    build_phase()
    kernel_lines = kernels_phase()
    launches = main_path_phase(card)
    for k in kernel_lines:
        k["launches"] = launches[k["name"]]
    import torch

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernel_lines}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
