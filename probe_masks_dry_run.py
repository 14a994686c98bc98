#!/usr/bin/env python3
"""Probe the flight recorder's packed component masks and the dry run (B9)
on one card, past what ``chip_smoke.py`` holds and times.

Run from the root of a checkout, on a machine with the card:

    python3 probe_masks_dry_run.py [--variants]

It builds the two libraries alone (printing ptxas' report), holds
``dry_run_preemption`` exactly to its plain version at 5120 nodes x K = 8,
128, 130 with D = 1, 3, 5 and at 64 nodes x K = 3000 (one node a block,
opting in to more shared memory) and K = 6000 (the rows read from global
memory), K3 over four logical shards, and ``filter_component_masks`` on
every row and on subsets, one row and repeated rows of the Basic, 4-pod,
affinity, spread and nominated batches. It prints one JSON line: CUDA-event
medians and ``torch.profiler`` card time of B9 (K = 8, 128), K3 and the
masks (every row; as the recorder and the bridge take them), the host µs a
call of the wrappers' parts (``host_us``), and the B9 kernel's steps
(``split``): a copy of its source with ``clock64()`` stamps in warp 0 of
each block (and ``%globaltimer`` at its start and end), built and swapped
in for the run, mean µs a step at 5120 x 8, 5120 x 128 and on one block.
``--variants`` also times B9 under other launch bounds and warps a block
(copies under ``build/variants``), each held exact.
"""
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

import chip_smoke as cs  # noqa: E402


def main():
    card = cs.device_phase()
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.ops import preemption as OP

    kernels.SOURCES = ("dry_run_preemption.cu", "filter_component_masks.cu")
    t0 = time.perf_counter()
    kernels.build()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    cs.log_build_report(kernels)
    results = {"filter_component_masks": {"cases": [], "max_abs_err": 0}}
    line = {"card": card}
    for K, D, seed in ((8, 3, 0), (8, 1, 2), (8, 5, 3), (128, 5, 1), (128, 1, 4),
                       (130, 1, 5), (130, 5, 6)):
        args = cs.victim_tensors(seed, 5120, K, D)
        cs.log(f"layout K={K} D={D}: {kernels.dry_run_layout(K, 3, 4, D)}")
        cs._dry_run_equal(f"5120x{K} D={D}", args)
        if (K, D) in ((8, 3), (128, 5)):
            line[f"b9_k{K}_ms"] = cs.cuda_ms(lambda: kernels.dry_run_preemption(*args), 20)
            line[f"b9_k{K}_device_ms"] = cs.kernel_device_ms(
                lambda: kernels.dry_run_preemption(*args), ("",), 5)
    # a node alone in a block (opting in), and past a block's staging: the
    # rows read from global memory
    for K in (3000, 6000):
        args = cs.victim_tensors(7, 64, K, 2)
        cs.log(f"layout K={K} D=2: {kernels.dry_run_layout(K, 3, 4, 2)}")
        cs._dry_run_equal(f"64x{K} D=2", args)
    # K3 over four logical shards
    for K, D in ((8, 3), (130, 5)):
        args = cs.victim_tensors(0, 5120, K, D)
        want = kernels.dry_run_preemption(*args)
        per = 5120 // 4
        rows = set(range(3, 15))
        shard_args = [tuple(x[g * per:(g + 1) * per].contiguous() if j in rows else x
                            for j, x in enumerate(args)) for g in range(4)]
        offsets = [g * per for g in range(4)]
        got = OP.dry_run_preemption_sharded(shard_args, offsets)
        plain = OP.dry_run_preemption_sharded_plain(shard_args, offsets)
        for other in (want, plain):
            assert int(got[0]) == int(other[0]), (int(got[0]), int(other[0]))
            for x, w in zip(got[1:], other[1:]):
                assert torch.equal(cs._whole(x), cs._whole(w))
        cs.log(f"K3 5120x{K} D={D}: node {int(got[0])}, equal")
        if K == 8:
            line["k3_ms"] = cs.cuda_ms(lambda: OP.dry_run_preemption_sharded(shard_args, offsets),
                                       20)
    # the masks
    b, params = cs.encode(*cs.basic_case(), C.Profile())
    for rows in (None, list(range(0, 1024, 7)), [5], [3, 3, 900, 3]):
        cs._masks_equal("Basic", b, params, rows, results)
    small, sp = cs.encode(*cs.basic_case(n_pending=4), C.Profile())
    cs._masks_equal("Basic 4 pods", small, sp, [0], results)
    cs._masks_equal("Basic 4 pods", small, sp, None, results)
    for name, case, prof in (
            ("affinity", cs.affinity_case(seed=2), C.Profile()),
            ("spread", cs.spread_case(seed=3), cs.spread_profiles()["spread"])):
        bb, pp = cs.encode(*case, prof)
        for rows in (None, list(range(0, bb.requests.shape[0], 5))):
            cs._masks_equal(name, bb, pp, rows, results)
    cache, pending, nom = cs.preemption_case()
    batch, pn = cs.encode_batch_full(cache, pending, C.Profile(), nom.entries())
    for rows in (None, list(range(0, 1024, 3))):
        cs._masks_equal("nominated", batch.device, pn, rows, results)
    cs.log(json.dumps(results))
    line["fcm_basic_all_ms"] = cs.cuda_ms(lambda: kernels.filter_component_masks(b, params), 20)
    line["fcm_basic_all_device_ms"] = cs.kernel_device_ms(
        lambda: kernels.filter_component_masks(b, params), ("",), 5)
    line.update(cs.masks_calls(b, params))
    line["fcm_recorder_device_ms"] = cs.kernel_device_ms(
        lambda: cs.masks_as_recorder(b, params, [1023]), ("",), 5)
    line["host_us"] = host_split(b, params)
    line["split"] = b9_split()
    if "--variants" in sys.argv[1:]:
        line["variants"] = b9_variants()
    cs.log(json.dumps({"probe_masks_dry_run": line}))


def b9_split():
    """A build of B9 that stamps clock64() (and %globaltimer) at its steps
    in warp 0 of each block; mean µs a step at 5120 x 8 and x 128 and at
    N = 8 (one block), the span over blocks, and the last block's merge."""
    import ctypes
    import subprocess

    import numpy as np
    import torch

    from kubetpu_torch import kernels

    src = (kernels.CSRC / "dry_run_preemption.cu").read_text()
    marks = [
        ("  const int64_t n = (int64_t)blockIdx.x * a.warps + warp;\n", 0, True),
        ("    cp_wait();\n    __syncwarp();\n", 1, False),
        ("    const bool fits_base = fits(v, own, -1, cnt, allowed, lane);\n", 2, False),
        ("    // PDB flags by prefix counts over the importance ranks\n", 3, True),
        ("    // the reprieve order, by counting", 4, True),
        ("    // the reprieve: a victim stays", 5, True),
        ("    // the victims row, and pick_node's keys\n", 6, True),
        ("    if (ok) mine = Cand{n_viol, max_prio, sum_prio, n_victims, earliest, n};\n", 7,
         False),
        ("  if (!s_last) return;\n", 8, True),
        ("    *a.node_idx = (int32_t)b.idx;\n", 9, False),
    ]
    head = ("__device__ unsigned long long g_marks[4096 * 12];\n"
            "__device__ unsigned long long g_time[4096 * 2];\n"
            "#define MARK(i) do { if (threadIdx.x == 0 && blockIdx.x < 4096) {"
            " g_marks[blockIdx.x * 12 + (i)] = clock64(); if ((i) == 0 || (i) == 8) {"
            " unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_));"
            " g_time[blockIdx.x * 2 + ((i) == 8)] = t_; } } } while (0)\n")
    for anchor, i, before in marks:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, (f"MARK({i});\n" + anchor) if before else
                          (anchor + f"MARK({i});\n"))
    src = src.replace("namespace {\n\n// a candidate node", head + "namespace {\n\n// a candidate node", 1)
    src += ('extern "C" int kt_marks(void* m, void* t) {\n'
            '  cudaError_t e = cudaMemcpyFromSymbol(m, g_marks, sizeof(g_marks));\n'
            '  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(t, g_time, sizeof(g_time));\n'
            '  return (int)e;\n}\n')
    vdir = REPO / "build" / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    path = vdir / "dry_split.cu"
    path.write_text(src)
    so = vdir / "libdry_split.so"
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                        "-o", str(so), str(path)], capture_output=True, text=True)
    if r.returncode:
        cs.log(r.stdout + r.stderr)
        return None
    lib = ctypes.CDLL(str(so))
    lib.kt_dry_run_preemption.argtypes = kernels._ARGTYPES["dry_run_preemption"]
    lib.kt_dry_run_preemption.restype = ctypes.c_int
    lib.kt_dry_run_preemption_smem.argtypes = [ctypes.c_int64] * 6
    lib.kt_dry_run_preemption_smem.restype = ctypes.c_int64
    lib.kt_dry_run_preemption_error.argtypes = [ctypes.c_int]
    lib.kt_dry_run_preemption_error.restype = ctypes.c_char_p
    lib0 = kernels._libs["dry_run_preemption"]
    kernels._libs["dry_run_preemption"] = lib
    clock_ghz = torch.cuda.get_device_properties(0).clock_rate / 1e6 \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") else 1.755
    out = {"clock_ghz": clock_ghz}
    for label, (N, K, D, seed) in {"k8": (5120, 8, 3, 0), "k128": (5120, 128, 5, 1),
                                   "k8_one_block": (8, 8, 3, 0)}.items():
        args = cs.victim_tensors(seed, N, K, D)
        for _ in range(3):
            kernels.dry_run_preemption(*args)
        torch.cuda.synchronize()
        m = np.zeros(4096 * 12, dtype=np.uint64)
        t = np.zeros(4096 * 2, dtype=np.uint64)
        assert lib.kt_marks(m.ctypes.data, t.ctypes.data) == 0
        blocks = -(-N // kernels.dry_run_layout(K, 3, 4, D)[0])
        m = m.reshape(4096, 12)[:blocks].astype(np.int64)
        t = t.reshape(4096, 2)[:blocks].astype(np.int64)
        steps = {f"{i}-{i + 1}": float(np.mean(m[:, i + 1] - m[:, i]) / clock_ghz / 1e3)
                 for i in range(8)}
        last = int(np.argmax(m[:, 9]))
        steps["merge_last_block"] = float((m[last, 9] - m[last, 8]) / clock_ghz / 1e3)
        steps["span_us"] = float((t[:, 1].max() - t[:, 0].min()) / 1e3)
        steps["block_us_mean"] = float(np.mean(t[:, 1] - t[:, 0]) / 1e3)
        steps["start_spread_us"] = float((t[:, 0].max() - t[:, 0].min()) / 1e3)
        out[label] = steps
    kernels._libs["dry_run_preemption"] = lib0
    kernels._dry_layouts.clear()
    return out


def b9_variants():
    """B9's device ms at 5120 x 8 (D = 3) and 5120 x 128 (D = 5) under other
    launch bounds (min blocks an SM) and warps a block, each held exact."""
    import ctypes
    import subprocess

    from kubetpu_torch import kernels

    src = (kernels.CSRC / "dry_run_preemption.cu").read_text()
    key = "__launch_bounds__(kMaxWarps * 32, 4)"
    assert key in src
    out = {}
    lib0 = kernels._libs["dry_run_preemption"]
    cases = {K: cs.victim_tensors(0 if K == 8 else 1, 5120, K, 3 if K == 8 else 5)
             for K in (8, 128)}
    vdir = REPO / "build" / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    for mb in (2, 4, 5, 6):
        path = vdir / f"dry_mb{mb}.cu"
        path.write_text(src.replace(key, f"__launch_bounds__(kMaxWarps * 32, {mb})"))
        so = vdir / f"libdry_mb{mb}.so"
        r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                            "-o", str(so), str(path)], capture_output=True, text=True)
        regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        lib.kt_dry_run_preemption.argtypes = kernels._ARGTYPES["dry_run_preemption"]
        lib.kt_dry_run_preemption.restype = ctypes.c_int
        lib.kt_dry_run_preemption_smem.argtypes = [ctypes.c_int64] * 6
        lib.kt_dry_run_preemption_smem.restype = ctypes.c_int64
        lib.kt_dry_run_preemption_error.argtypes = [ctypes.c_int]
        lib.kt_dry_run_preemption_error.restype = ctypes.c_char_p
        kernels._libs["dry_run_preemption"] = lib
        for warps in (4, 8):
            kernels._DRY_MAX_WARPS = warps
            kernels._dry_layouts.clear()
            for K, args in cases.items():
                cs._dry_run_equal(f"mb{mb} w{warps} 5120x{K}", args)
                out[f"mb{mb}_w{warps}_k{K}"] = cs.kernel_device_ms(
                    lambda args=args: kernels.dry_run_preemption(*args), ("dry_run",), 10)
        out[f"mb{mb}_ptxas"] = regs[-2:]
    kernels._libs["dry_run_preemption"] = lib0
    kernels._DRY_MAX_WARPS = 8
    kernels._dry_layouts.clear()
    return out


def host_split(b, params):
    """Host µs a call of the wrappers' parts (enqueue only, no wait)."""
    import torch

    from kubetpu_torch import kernels
    from kubetpu_torch.framework import runtime as rt

    out = {}

    def tm(name, fn, reps=300):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()

    P = b.requests.shape[0]
    x = torch.zeros((1, 5120), dtype=torch.uint8, device="cuda")
    tm("batch_args", lambda: kernels._batch_args(b, params))
    tm("component_flags", lambda: kernels._component_flags(b, params))
    tm("mask_plan_row", lambda: kernels.mask_plan(rt.pod_classes(b), [1023], P))
    tm("mask_plan_all", lambda: kernels.mask_plan(rt.pod_classes(b), None, P))
    tm("empty", lambda: torch.empty((5120,), dtype=torch.uint8, device="cuda"))
    tm("view", lambda: x[0:].view(1, 5120))
    tm("pinned_empty", lambda: torch.empty((1, 5120), dtype=torch.uint8, pin_memory=True))
    tm("raw_stream", lambda: kernels._raw_stream(0))
    tm("masks_row0_enqueue", lambda: kernels.filter_component_masks(b, params, [0]))
    tm("masks_row_enqueue", lambda: kernels.filter_component_masks(b, params, [1023]))
    tm("masks_all_enqueue", lambda: kernels.filter_component_masks(b, params))
    tm("cpu_copy_row", lambda: x[0].cpu())
    tm("recorder_row", lambda: cs.masks_as_recorder(b, params, [1023]))
    args = cs.victim_tensors(0, 5120, 8, 3)
    tm("b9_enqueue", lambda: kernels.dry_run_preemption(*args))
    tm("b9_layout", lambda: kernels.dry_run_layout(8, 3, 4, 3))
    tm("check", lambda: kernels._check("v_req", args[12], torch.int64, (5120, 8, 3),
                                       args[12].device))
    return out


if __name__ == "__main__":
    main()
