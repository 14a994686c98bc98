#!/usr/bin/env python3
"""Time variants of the greedy scan's loop side by side on one card.

Run from the root of a checkout, on a machine with the card:

    python3 scan_variants.py

Each variant is a copy of ``kubetpu_torch/kernels/csrc`` under
``build/scan_variants/<name>`` with the edits of ``VARIANTS`` applied (exact
string replacements, each of which must match once), built as the scan's
timing build (``scan_split.cu``, the kernels' nvcc flags; all variants'
nvcc started together). On the SchedulingBasic and PreferredTopologySpreading
cycles (1024 x 5120), each variant's ``greedy_scan`` median (CUDA events)
and step split (``chip_smoke.scan_split``) print as one JSON line, the
variants timed in turns (forward, then backward). A variant whose name
starts with ``t_`` times a part of the step by leaving it out: its
assignments are not those of the scan and are not checked; every other
variant's must equal the kernel's.
"""

import json
import shutil
import subprocess
from pathlib import Path

import chip_smoke as cs

# name -> (source file, old text, new text) edits
VARIANTS = {
    "base": [],
    # the recompute of the node a step changed, left out (its verdict false)
    "t_no_recompute": [("scan_loop.cuh", """      const bool fits = from_held ? held_verdict(a, q, held, ports)
                                  : kt::pair_feasible_eager(a, q, n, req, pc, ports);""",
                        "      const bool fits = false;")],
    # the recompute's base score left out
    "t_no_base": [("scan_loop.cuh", """      const int64_t base =
          from_held ? kt::base_score_warp_v(a, q, n, held.cap, held.req, held.nz)
          : R <= 32 ? kt::base_score_warp(a, q, n, req, nz)
                    : kt::base_score_of(a, q, n, req, nz);""", "      const int64_t base = 0;")],
    "chunk4": [("scan_loop.cuh", "constexpr int kChunk = 8;", "constexpr int kChunk = 4;")],
    "chunk16": [("scan_loop.cuh", "constexpr int kChunk = 8;", "constexpr int kChunk = 16;")],
}


def build_variants(kernels, root: Path) -> dict:
    """Every variant's timing build, loaded (``chip_smoke.load_split_lib``)."""
    procs = {}
    for name, edits in VARIANTS.items():
        d = root / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(kernels.CSRC, d / "csrc")
        for fname, old, new in edits:
            src = (d / "csrc" / fname).read_text()
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: the edit of {fname} matches "
                                 f"{src.count(old)} times")
            (d / "csrc" / fname).write_text(src.replace(old, new))
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "csrc" / "scan_split.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        libs[name] = cs.load_split_lib(kernels, root / name / "lib.so")
    return libs


def main() -> int:
    card = cs.device_phase()
    from kubetpu_torch import kernels
    from kubetpu_torch.framework import config as C
    from kubetpu_torch.perf import workloads as W

    kernels.build()
    libs = build_variants(kernels, kernels.BUILD_DIR.parent / "scan_variants")
    batches = {
        "basic": cs.encode(*cs.basic_case(), C.Profile()),
        "preferred": cs.encode(*cs.topology_case(W.pod_with_preferred_topology_spreading),
                               C.Profile()),
    }
    for bname, (b, params) in batches.items():
        for name in list(libs) + list(libs)[::-1]:
            split = cs.scan_split(kernels, libs[name], b, params, check=not name.startswith("t_"))
            real = kernels._libs["greedy_scan"]
            kernels._libs["greedy_scan"] = libs[name]
            try:
                ms = cs.cuda_ms(lambda: kernels.greedy_scan(b, params), 5)
            finally:
                kernels._libs["greedy_scan"] = real
            cs.log(json.dumps({"variant": name, "batch": bname, "card": card, "ms": ms,
                               "split": split}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
