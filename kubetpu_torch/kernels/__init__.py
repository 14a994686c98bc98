"""The hand-written CUDA kernels of the main paths, and their wrappers.

``csrc/filter_score.cu``, ``csrc/greedy_scan.cu``,
``csrc/batched_round.cu`` and ``csrc/hypothesis_scan.cu`` (the greedy scan
under many node-set hypotheses: the gang lane's placement search and gang
dry run; it shares ``csrc/scan_loop.cuh`` with ``greedy_scan.cu``; its
library also holds the batched engine's ``hypothesis_rows`` and
``slice_epilogue`` kernels for the same two searches) (all built on
``csrc/score_common.cuh``),
``csrc/scatter_rows.cu`` (the resident node block's dirty-row scatter,
driven by a launch plan the block keeps: ``ScatterLaunch``),
``csrc/dry_run_preemption.cu`` (the preemption victim search), and the
flight recorder's ``csrc/explain_summary.cu`` (``filter_score``'s passes
on the batch's pod classes, then one pass over (class, node tile) blocks)
and
``csrc/filter_component_masks.cu`` (also the extender bridge's per-plugin
masks), and the packing engine's ``csrc/packing_round.cu`` and the
batched engine's ``csrc/batched_round.cu`` (each engine's whole solve in
one cooperative launch: the rounds with each one's Filter + Score through
``csrc/filter_pass.cuh``, which ``filter_score.cu`` shares, and the stop
rule, the steps separated by the grid barriers of ``csrc/solve_sync.cuh``)
are compiled at first use, for ``sm_90a``, one ``nvcc`` per source
started together, each into a shared library with a plain C interface
that ``ctypes`` loads. No PyTorch header is compiled, so
a build takes seconds. Outputs go to ``build/kubetpu_torch_kernels/`` under
the repository root, keyed by a hash of the sources and flags.

Under a mesh (``parallel.mesh``) more kernels run on the shards, each
held to a plain version that reduces across the shards explicitly. On a
pods x nodes grid, K6 is the batched solve over the grid's tiles, one
cooperative launch a solve on each card holding the card's tiles
(``batched_round.cu``, the same kernel as the unsharded B6), and K7 the
scan one node column a block, pod row after pod row, exchanging partials
inside the kernel through ``csrc/exchange.cuh`` (``greedy_scan.cu``
``tiled_scan_kernel``); on a node mesh, the grid of one pod row, the same
two kernels are K2 and K1. ``shard_combine`` (``batched_round.cu``)
joins the shards' partials between the sharded ``filter_score`` passes
of ``filter_score.cu``. K3 is the dry run's cross-shard pick
(``dry_run_preemption.cu``) and K4 the exchange's argmax probe
(``greedy_scan.cu``); ``scatter_rows`` runs on each shard's card for the
routed delta (B5m). K8 is the packing solve over a grid's tiles, one
cooperative launch a solve on each card holding the card's tiles
(``packing_round.cu``, the same kernel as the unsharded B14), the tiles
combining their partials inside it and the cards through the exchange's
sequence words; on a node mesh, one pod row, it is K5.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``, launches on the
current CUDA stream, raises if the launch was refused, and adds one to its
entry of ``launch_counts``. No wrapper falls back to the plain version: the
callers (``framework.runtime.filter_score_batch``,
``framework.runtime.ScatterPlan``,
``assign.greedy.greedy_assign_device``,
``assign.batched.batched_assign_device``,
``assign.placement.placement_assign_device``,
``assign.packing.packing_assign_device``,
``ops.preemption.dry_run_preemption``,
``ops.preemption.dry_run_gang_preemption``,
``framework.preemption.PreemptionEvaluator``, ``sched.flightrecorder``'s
``_explain_kernel`` / ``_explain_masks_kernel``, ``bridge.server``) choose
the plain version only for tensors that live on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..framework import config as C
from ..framework import runtime as rt

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("filter_score.cu", "greedy_scan.cu", "batched_round.cu", "scatter_rows.cu",
           "dry_run_preemption.cu", "explain_summary.cu", "filter_component_masks.cu",
           "hypothesis_scan.cu", "packing_round.cu")
# the libraries that take the ScoreArgs struct (score_common.cuh)
SCORE_ARGS_LIBS = ("filter_score", "greedy_scan", "batched_round", "explain_summary",
                   "filter_component_masks", "hypothesis_scan", "packing_round")
HEADERS = ("score_common.cuh", "score_prelaunch.cuh", "filter_pass.cuh", "scan_loop.cuh",
           "exchange.cuh", "solve_sync.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubetpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # the balanced score's float64 arithmetic must round like the plain
    # version's separate operations: no contraction into fused multiply-add
    # (score_common.cuh also uses explicitly rounded intrinsics), and no
    # --use_fast_math
    "-fmad=false",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

# launches of each kernel since the last reset_launch_counts(); chip_smoke
# reads them around the main path to show the path went through the kernels
launch_counts = {
    "filter_score": 0, "greedy_scan": 0, "batched_round": 0, "scatter_rows": 0,
    "dry_run_preemption": 0, "explain_summary": 0, "filter_component_masks": 0,
    "hypothesis_scan": 0, "hypothesis_rows": 0, "slice_epilogue": 0,
    "packing_round": 0, "packing_log1p": 0,
    # the mesh's kernels (K1-K8): one count a shard's (a tile's) block
    # launched; the packing and batched solves (B14, K5, K8; B6, K2, K6)
    # one a solve on each card. The tiled scan and the two solves count
    # under "sharded_scan" / "sharded_round" / "sharded_packing" (K1, K2,
    # K5) on a node mesh (one pod row) and under "tiled_scan" /
    # "tiled_round" / "tiled_packing" (K7, K6, K8) on a grid
    "sharded_scan": 0, "sharded_round": 0, "shard_pick": 0, "shard_argmax": 0,
    "sharded_packing": 0, "tiled_round": 0, "tiled_scan": 0, "tiled_packing": 0,
}

# ctypes argument types of each library's entry point
_ARGTYPES = {
    "filter_score": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_int64]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p],
    "greedy_scan": [ctypes.c_void_p] * 13 + [ctypes.c_int64, ctypes.c_void_p],
    "batched_round": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
    "scatter_rows": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p],
    "dry_run_preemption": [ctypes.c_void_p] * 2,
    "explain_summary": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    + [ctypes.c_int] * 2 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    + [ctypes.c_void_p] * 6,
    "filter_component_masks": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 2,
    "hypothesis_scan": [ctypes.c_void_p] * 17 + [ctypes.c_int64] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64] * 2 + [ctypes.c_void_p],
    "packing_round": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
}
# the entry points a library has beside its own
_MORE_ENTRIES = {
    "filter_score": {
        "kt_filter_score_shard": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
        + [ctypes.c_int64, ctypes.c_void_p],
    },
    "batched_round": {
        "kt_shard_combine": [ctypes.c_void_p] * 2,
    },
    "greedy_scan": {
        "kt_shard_argmax": [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int,
                                                    ctypes.c_int64] + [ctypes.c_void_p] * 2,
        "kt_enable_peer_access": [ctypes.c_int],
        "kt_tiled_scan": [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_int64]
        + [ctypes.c_int] * 3 + [ctypes.c_int64, ctypes.c_void_p],
    },
    "dry_run_preemption": {
        "kt_dry_run_shard_pick": [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 2,
    },
    "hypothesis_scan": {
        "kt_hypothesis_rows": [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 12,
        "kt_slice_epilogue": [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p],
    },
    "packing_round": {
        "kt_packing_log1p": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p],
    },
}

# entry points that return an int64 (a size), beside the struct sizes
_INT64_ENTRIES = {
    "dry_run_preemption": {"kt_dry_run_preemption_smem": [ctypes.c_int64] * 6},
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: dict[str, str] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> dict[str, ctypes.CDLL]:
    """Compile (once per source hash) and load every kernel library. All
    ``nvcc`` processes start together and are waited for; a failed build
    raises with the compiler's output. ``build_log`` keeps each source's
    compiler output (``-Xptxas=-v``: registers, spills, shared memory).
    Each library that takes an argument struct (``ScoreArgs``,
    ``DryRunArgs``) reports its size as compiled; a size that differs from
    the ctypes mirror's raises (a layout that drifts would read garbage with
    no error)."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_DIR / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src in SOURCES:
            lib = out_dir / ("lib" + src.replace(".cu", ".so"))
            if lib.exists():
                continue
            tmp = out_dir / (lib.name + f".{os.getpid()}.tmp")
            procs[src] = (lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for src, (lib, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            build_log[src] = log
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        libs = {}
        for src in SOURCES:
            name = src.replace(".cu", "")
            lib = ctypes.CDLL(str(out_dir / ("lib" + name + ".so")))
            fn = getattr(lib, "kt_" + name)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            for entry, argtypes in _MORE_ENTRIES.get(name, {}).items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
            for entry, argtypes in _INT64_ENTRIES.get(name, {}).items():
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int64
            err = getattr(lib, f"kt_{name}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            mirror = (ScoreArgs if name in SCORE_ARGS_LIBS
                      else DryRunArgs if name == "dry_run_preemption" else None)
            if mirror is not None:
                size = getattr(lib, f"kt_{name}_args_size")
                size.argtypes = []
                size.restype = ctypes.c_int64
                if size() != ctypes.sizeof(mirror):
                    raise RuntimeError(
                        f"{src}: sizeof({mirror.__name__}) is {size()} bytes, the "
                        f"ctypes mirror's {ctypes.sizeof(mirror)}: the two layouts differ"
                    )
            for entry, struct in _STRUCT_SIZES.get(name, ()):
                size = getattr(lib, entry)
                size.argtypes = []
                size.restype = ctypes.c_int64
                if size() != ctypes.sizeof(struct):
                    raise RuntimeError(
                        f"{src}: {entry}() is {size()} bytes, the ctypes mirror "
                        f"{struct.__name__}'s {ctypes.sizeof(struct)}: the layouts differ")
            libs[name] = lib
        _libs.update(libs)
        return _libs


class ScoreArgs(ctypes.Structure):
    """Mirror of ``struct ScoreArgs`` in csrc/score_common.cuh (every field
    8 bytes, in the same order)."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in (
            "alloc", "requested", "nonzero_requested", "pod_count",
            "allowed_pods", "node_valid", "node_ports", "requests",
            "nonzero_requests", "pod_valid", "pod_ports", "port_conflict",
            "static_mask", "static_sig", "na_raw", "tt_raw", "score_sig",
            "img_sums", "img_sig", "img_count", "params",
        )
    ] + [
        (name, ctypes.c_int64) for name in (
            "P", "N", "R", "K", "B", "strategy", "w_fit", "w_balanced",
            "w_na", "w_taint", "w_image", "filter_fit", "filter_ports",
        )
    ] + [
        (name, ctypes.c_void_p) for name in (
            "pa_node_domain", "pa_has_key", "pa_sums", "pa_row_total",
            "pa_update", "pa_fa_rows", "pa_fa_self", "pa_ra_rows",
            "pa_ea_rows", "pa_score_rows", "pa_score_vals",
        )
    ] + [
        (name, ctypes.c_int64) for name in (
            "pa_R", "pa_D", "pa_CA", "pa_CR", "pa_CE", "pa_CS", "pa_filter",
            "w_interpod",
        )
    ] + [
        (name, ctypes.c_void_p) for name in (
            "sp_eligible", "sp_node_domain", "sp_has_key", "sp_domain_present",
            "sp_num_domains", "sp_is_hostname", "sp_counts", "sp_sums",
            "sp_min_match", "sp_sig_idx", "sp_action", "sp_max_skew",
            "sp_min_domains", "sp_self_match", "sp_pod_match_sig", "sp_ignored",
            "sp_bits",
        )
    ] + [
        (name, ctypes.c_int64) for name in (
            "sp_S", "sp_D", "sp_C", "sp_filter", "w_spread",
        )
    ] + [
        (name, ctypes.c_void_p) for name in (
            "nom_node", "nom_req", "nom_gate", "nom_ports", "nom_pod_idx",
            "nom_active",
        )
    ] + [("G", ctypes.c_int64)] + [
        (name, ctypes.c_void_p) for name in (
            "ext_mask", "ext_score", "dra_raw", "dra_sig",
        )
    ] + [("w_dra", ctypes.c_int64)]


class DryRunArgs(ctypes.Structure):
    """Mirror of ``struct DryRunArgs`` in csrc/dry_run_preemption.cu (every
    field 8 bytes, in the same order)."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in (
            "pod_req", "wants_conf", "potential", "alloc", "requested",
            "pod_count", "allowed", "port_counts", "v_valid", "v_prio",
            "v_start", "v_req", "v_ports", "v_pdb", "pdb_allowed",
            "node_idx", "victims", "ok", "n_pdb", "best", "parts", "ticket",
        )
    ] + [
        (name, ctypes.c_int64) for name in (
            "pod_prio", "N", "K", "R", "Kp", "D", "warps", "stage", "smem")
    ]

class Exchange(ctypes.Structure):
    """Mirror of ``struct Exchange`` in csrc/exchange.cuh."""

    _fields_ = [("slot", ctypes.c_void_p * 8), ("G", ctypes.c_int64),
                ("words", ctypes.c_int64), ("epoch", ctypes.c_int64),
                ("budget", ctypes.c_int64), ("error", ctypes.c_void_p)]


class ScanShard(ctypes.Structure):
    """Mirror of ``struct ScanShard`` in csrc/greedy_scan.cu."""

    _fields_ = [("a", ScoreArgs)] + [
        (name, ctypes.c_void_p) for name in (
            "mask0", "base0", "touched", "assignments", "req", "nz", "pc", "ports",
            "pa_sums", "row_total", "sp_counts", "ok_buf",
        )
    ] + [("offset", ctypes.c_int64)]


class ArgmaxShard(ctypes.Structure):
    """Mirror of ``struct ArgmaxShard`` in csrc/greedy_scan.cu."""

    _fields_ = [("vals", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("offset", ctypes.c_int64), ("g", ctypes.c_int64),
                ("out", ctypes.c_void_p)]


class CombineArgs(ctypes.Structure):
    """Mirror of ``struct CombineArgs`` in csrc/batched_round.cu."""

    _fields_ = [("src", ctypes.c_void_p * 8), ("dst", ctypes.c_void_p * 8),
                ("G", ctypes.c_int64), ("n", ctypes.c_int64), ("op", ctypes.c_int64),
                ("elem", ctypes.c_int64)]


class SolveTile(ctypes.Structure):
    """Mirror of ``struct SolveTile`` in csrc/packing_round.cu."""

    _fields_ = [("a", ScoreArgs), ("af", ScoreArgs)] + [
        (name, ctypes.c_void_p) for name in ("reps", "class_of")] + [("C", ctypes.c_int64)] + [
        (name, ctypes.c_void_p) for name in (
            "mask", "total", "ties", "cstats", "sc", "bits", "mx", "sums_part", "busy", "pen",
            "lam", "over", "chosen", "endf", "req", "nz", "pc", "ports", "pa_sums", "pa_delta",
            "sp_counts", "w", "slice_id")] + [("S", ctypes.c_int64)] + [
        (name, ctypes.c_void_p) for name in (
            "order", "byorder", "coupled", "active", "assignments", "choice", "acc",
            "req0", "pc0",
            "prio", "scal", "objective", "nodes_used")] + [
        (name, ctypes.c_int64) for name in ("offset", "row", "col")]


# the fields of a solve's launch struct after its tiles (SolveSet, BatchSet)
_SET_FIELDS = [("PG", ctypes.c_int64), ("NG", ctypes.c_int64),
               ("local", ctypes.c_int64 * 8)] + [
    (name, ctypes.c_int64) for name in ("nlocal", "bpt", "cap")] + [
    (name, ctypes.c_void_p) for name in ("bar", "abort", "out", "split")] + [
    ("x", Exchange), ("card", ctypes.c_int64)]


class SolveSet(ctypes.Structure):
    """Mirror of ``struct SolveSet`` in csrc/packing_round.cu."""

    _fields_ = [("t", SolveTile * 8)] + _SET_FIELDS


class BatchTile(ctypes.Structure):
    """Mirror of ``struct BatchTile`` in csrc/batched_round.cu."""

    _fields_ = [("a", ScoreArgs), ("af", ScoreArgs)] + [
        (name, ctypes.c_void_p) for name in ("reps", "class_of")] + [("C", ctypes.c_int64)] + [
        (name, ctypes.c_void_p) for name in (
            "mask", "total", "ties", "cstats", "sc", "bits", "mx", "sums_part", "first", "req",
            "nz", "pc", "ports", "pa_sums", "pa_delta", "sp_counts", "req0", "nz0", "pc0",
            "ports0", "pa0", "sp0", "active", "assignments", "choice", "acc", "scal")] + [
        (name, ctypes.c_int64) for name in ("offset", "row", "col")]


class BatchSet(ctypes.Structure):
    """Mirror of ``struct BatchSet`` in csrc/batched_round.cu."""

    _fields_ = [("t", BatchTile * 8)] + _SET_FIELDS


class ScatterPlanArgs(ctypes.Structure):
    """Mirror of ``struct ScatterPlan`` in csrc/scatter_rows.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "alloc", "req", "nz", "pc", "al", "vd")] + [("N", ctypes.c_int64), ("R", ctypes.c_int64)]


class PickShard(ctypes.Structure):
    """Mirror of ``struct PickShard`` in csrc/dry_run_preemption.cu."""

    _fields_ = [("best", ctypes.c_void_p), ("offset", ctypes.c_int64)]


# the structs whose compiled size each library reports beside its args
_STRUCT_SIZES = {
    "greedy_scan": (("kt_greedy_scan_shard_size", ScanShard),
                    ("kt_greedy_scan_exchange_size", Exchange),
                    ("kt_greedy_scan_argmax_size", ArgmaxShard)),
    "dry_run_preemption": (("kt_dry_run_preemption_pick_size", PickShard),),
    "batched_round": (("kt_batched_round_combine_size", CombineArgs),
                      ("kt_batched_round_set_size", BatchSet)),
    "packing_round": (("kt_packing_round_set_size", SolveSet),),
    "scatter_rows": (("kt_scatter_rows_plan_size", ScatterPlanArgs),),
}

# dynamic shared memory a spread-scoring block takes at most: static and
# dynamic shared memory together stay under the 48 KiB a launch gets
# without opting in (the blocks' static arrays take about 2 KiB)
_SMEM_LIMIT = 40 * 1024


_STRATEGIES = {
    C.LEAST_ALLOCATED: 0,
    C.MOST_ALLOCATED: 1,
    C.REQUESTED_TO_CAPACITY_RATIO: 2,
}


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> int:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, batch is on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, kernel takes {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return x.data_ptr()


def _require_cuda(dev: torch.device, where: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{where}: the kernel takes CUDA tensors, batch is on {dev}")


def _score_args(b: rt.DeviceBatch, p: rt.ScoreParams, where: str, state=None,
                bits_blocks: int = 0, nom_active: torch.Tensor | None = None,
                pod_node: bool = True):
    """Validate the batch for the kernels and pack their argument struct.
    ``state``, when given, is a running ``(requested, nonzero_requested,
    pod_count, node_ports, pa_sums, spread_counts)`` the kernels read in
    place of the batch's (``pa_sums`` None without affinity rows,
    ``spread_counts`` None without a spread leaf). ``bits_blocks`` is the
    number of blocks that each need a domain bitmap of their own when the
    bitmap does not fit in shared memory (see ``_spread_smem``).
    ``nom_active`` (G,) bool, with nominations, is the live-nomination
    flags the kernels read (and the engines clear); all set when None.
    Without ``pod_node`` the (P, N) leaves (the spread's ignored rows, the
    extender terms) are left out: the commit of a round over a grid reads
    every pod's pod-major leaves and none of them. Returns ``(args,
    keepalive)``."""
    dev = b.alloc.device
    _require_cuda(dev, where)
    if p.strategy not in _STRATEGIES:
        raise ValueError(f"{where}: unknown scoring strategy {p.strategy!r}")
    N, R = b.alloc.shape
    P = b.requests.shape[0]
    K = b.port_conflict.shape[0]
    if P > 65535:
        raise ValueError(f"{where}: P={P} exceeds the grid's y extent")
    i64, i32, u8 = torch.int64, torch.int32, torch.bool
    req, nz, pc, ports, pa_sums, sp_counts = state or (
        b.requested, b.nonzero_requested, b.pod_count, b.node_ports, None, None
    )
    a = ScoreArgs()
    a.alloc = _check("alloc", b.alloc, i64, (N, R), dev)
    a.requested = _check("requested", req, i64, (N, R), dev)
    a.nonzero_requested = _check("nonzero_requested", nz, i64, (N, R), dev)
    a.pod_count = _check("pod_count", pc, i32, (N,), dev)
    a.allowed_pods = _check("allowed_pods", b.allowed_pods, i32, (N,), dev)
    a.node_valid = _check("node_valid", b.node_valid, u8, (N,), dev)
    a.node_ports = _check("node_ports", ports, u8, (N, K), dev)
    a.requests = _check("requests", b.requests, i64, (P, R), dev)
    a.nonzero_requests = _check("nonzero_requests", b.nonzero_requests, i64, (P, R), dev)
    a.pod_valid = _check("pod_valid", b.pod_valid, u8, (P,), dev)
    a.pod_ports = _check("pod_ports", b.pod_ports, u8, (P, K), dev)
    a.port_conflict = _check("port_conflict", b.port_conflict, u8, (K, K), dev)

    def rows(name, leaf, sig, sig_name, dtype):
        if leaf is None:
            return None, None
        if sig is None:
            raise ValueError(
                f"{where}: {name} without {sig_name}: the kernel takes "
                "signature-compressed rows"
            )
        return (
            _check(name, leaf, dtype, (leaf.shape[0], N), dev),
            _check(sig_name, sig, i32, (P,), dev),
        )

    a.static_mask, a.static_sig = rows(
        "static_mask", b.static_mask, b.static_sig, "static_sig", u8)
    na = b.node_affinity_raw if p.w_node_affinity else None
    tt = b.taint_prefer_raw if p.w_taint else None
    a.na_raw, sig_na = rows("node_affinity_raw", na, b.score_sig, "score_sig", i64)
    a.tt_raw, sig_tt = rows("taint_prefer_raw", tt, b.score_sig, "score_sig", i64)
    a.score_sig = sig_na or sig_tt
    img = b.image_sum_scores if p.w_image else None
    a.img_sums, a.img_sig = rows("image_sum_scores", img, b.image_sig, "image_sig", i64)
    if img is not None:
        if b.image_count is None:
            raise ValueError(f"{where}: image_sum_scores without image_count")
        a.img_count = _check("image_count", b.image_count, i32, (P,), dev)
    B = len(p.shape_x)
    for name, v in (("fit_weights", p.fit_weights),
                    ("balanced_weights", p.balanced_weights),
                    ("is_scalar", p.is_scalar)):
        if len(v) != R:
            raise ValueError(f"{where}: params.{name} has {len(v)} entries, R={R}")
    if len(p.shape_y) != B or B < 1:
        raise ValueError(f"{where}: bad RequestedToCapacityRatio shape")
    params = _params_on(p, dev)
    a.params = params.data_ptr()
    a.P, a.N, a.R, a.K, a.B = P, N, R, K, B
    a.strategy = _STRATEGIES[p.strategy]
    a.w_fit, a.w_balanced = p.w_fit, p.w_balanced
    a.w_na, a.w_taint, a.w_image = p.w_node_affinity, p.w_taint, p.w_image
    a.filter_fit, a.filter_ports = int(p.filter_fit), int(p.filter_ports)
    keep = [params]
    pa = b.podaffinity
    if pa is not None:
        RA, D = pa.base_sums.shape
        sums = pa.base_sums if pa_sums is None else pa_sums
        a.pa_node_domain = _check("pa.node_domain", pa.node_domain, i32, (RA, N), dev)
        a.pa_has_key = _check("pa.has_key", pa.has_key, u8, (RA, N), dev)
        a.pa_sums = _check("pa_sums", sums, i64, (RA, D), dev)
        a.pa_update = _check("pa.update", pa.update, i64, (P, RA), dev)
        slots = {}
        for name in ("fa_rows", "ra_rows", "ea_rows", "score_rows"):
            leaf = getattr(pa, name)
            slots[name] = leaf.shape[1] if leaf.dim() == 2 else -1
            setattr(a, "pa_" + name,
                    _check("pa." + name, leaf, i32, (P, slots[name]), dev))
        a.pa_fa_self = _check("pa.fa_self", pa.fa_self, u8, (P,), dev)
        a.pa_score_vals = _check(
            "pa.score_vals", pa.score_vals, i64, (P, slots["score_rows"]), dev)
        row_total = torch.empty((RA,), dtype=i64, device=dev)
        keep.append(row_total)
        a.pa_row_total = row_total.data_ptr()
        a.pa_R, a.pa_D = RA, D
        a.pa_CA, a.pa_CR = slots["fa_rows"], slots["ra_rows"]
        a.pa_CE, a.pa_CS = slots["ea_rows"], slots["score_rows"]
        a.pa_filter = int(p.filter_interpod and pa.has_filter_work)
        a.w_interpod = p.w_interpod if pa.has_score_work else 0
    sp = b.spread
    if sp is not None:
        S, D = sp.domain_present.shape
        C = sp.sig_idx.shape[1]
        counts = sp.node_count if sp_counts is None else sp_counts
        a.sp_eligible = _check("sp.eligible", sp.eligible, u8, (S, N), dev)
        a.sp_node_domain = _check("sp.node_domain", sp.node_domain, i32, (S, N), dev)
        a.sp_has_key = _check("sp.has_key", sp.has_key, u8, (S, N), dev)
        a.sp_domain_present = _check(
            "sp.domain_present", sp.domain_present, u8, (S, D), dev)
        a.sp_num_domains = _check("sp.num_domains", sp.num_domains, i32, (S,), dev)
        a.sp_is_hostname = _check("sp.is_hostname", sp.is_hostname, u8, (S,), dev)
        a.sp_counts = _check("spread_counts", counts, i32, (S, N), dev)
        for name, dtype in (("sig_idx", i32), ("action", torch.int8),
                            ("max_skew", i32), ("min_domains", i32),
                            ("self_match", i32)):
            setattr(a, "sp_" + name,
                    _check("sp." + name, getattr(sp, name), dtype, (P, C), dev))
        a.sp_pod_match_sig = _check(
            "sp.pod_match_sig", sp.pod_match_sig, u8, (P, S), dev)
        if pod_node:
            a.sp_ignored = _check("sp.ignored", sp.ignored, u8, (P, N), dev)
        sums = torch.empty((S, D + 1), dtype=i64, device=dev)
        min_match = torch.empty((S,), dtype=i64, device=dev)
        keep += [sums, min_match]
        a.sp_sums, a.sp_min_match = sums.data_ptr(), min_match.data_ptr()
        if bits_blocks and _spread_smem(C, D)[1]:
            bits = torch.empty((bits_blocks, (D + 31) // 32), dtype=torch.int32,
                               device=dev)
            keep.append(bits)
            a.sp_bits = bits.data_ptr()
        a.sp_S, a.sp_D, a.sp_C = S, D, C
        a.sp_filter = int(p.filter_spread and sp.has_hard)
        a.w_spread = p.w_spread if sp.has_soft else 0
    if b.nominated_node is not None:
        G = b.nominated_node.shape[0]
        a.nom_node = _check("nominated_node", b.nominated_node, i32, (G,), dev)
        a.nom_req = _check("nominated_req", b.nominated_req, i64, (G, R), dev)
        a.nom_gate = _check("nominated_gate", b.nominated_gate, u8, (P, G), dev)
        if b.nominated_ports is not None:
            a.nom_ports = _check("nominated_ports", b.nominated_ports, u8, (G, K), dev)
        pod_idx = b.nominated_pod_idx
        if pod_idx is None:
            pod_idx = torch.full((G,), -1, dtype=i32, device=dev)
            keep.append(pod_idx)
        a.nom_pod_idx = _check("nominated_pod_idx", pod_idx, i32, (G,), dev)
        if nom_active is None:
            nom_active = torch.ones((G,), dtype=u8, device=dev)
            keep.append(nom_active)
        a.nom_active = _check("nominated_active", nom_active, u8, (G,), dev)
        a.G = G
    if (b.extender_mask is None) != (b.extender_score is None):
        raise ValueError(f"{where}: extender_mask and extender_score come together")
    if b.extender_mask is not None and pod_node:
        a.ext_mask = _check("extender_mask", b.extender_mask, u8, (P, N), dev)
        a.ext_score = _check("extender_score", b.extender_score, i64, (P, N), dev)
    dra = b.dra_score_raw if p.w_dra else None
    a.dra_raw, a.dra_sig = rows("dra_score_raw", dra, b.dra_score_sig, "dra_score_sig", i64)
    if dra is not None:
        a.w_dra = p.w_dra
    return a, keep


# each (ScoreParams, device)'s params table on the device, uploaded once
_params_cache: dict = {}


def _params_on(p: rt.ScoreParams, dev: torch.device) -> torch.Tensor:
    """The kernels' int64 params table of ``p`` (fit and balanced weights,
    scalar flags, the RequestedToCapacityRatio shape) on ``dev``: uploaded
    at its first use, then kept (a profile's params are few and never
    written)."""
    t = _params_cache.get((p, dev))
    if t is None:
        t = _params_cache[(p, dev)] = torch.tensor(
            list(p.fit_weights) + list(p.balanced_weights)
            + [int(s) for s in p.is_scalar] + list(p.shape_x) + list(p.shape_y),
            dtype=torch.int64,
        ).to(dev, non_blocking=False)
    return t


def _spread_smem(C: int, D: int) -> tuple[int, bool]:
    """Dynamic shared memory of a spread-scoring block: C float64 slot
    weights and, when it fits beside them, the ceil(D / 32)-word domain
    bitmap. Returns ``(bytes, bitmap_in_global)``."""
    weights = 8 * C
    bitmap = 4 * ((D + 31) // 32)
    if weights + bitmap <= _SMEM_LIMIT:
        return weights + bitmap, False
    return weights, True


def _smem(b: rt.DeviceBatch) -> int:
    sp = b.spread
    if sp is None:
        return 0
    return _spread_smem(sp.sig_idx.shape[1], sp.domain_present.shape[1])[0]


# the greedy scan's block (scan_loop.cuh kThreads; thread t owns nodes t,
# t + SCAN_THREADS, ...) and the nodes it takes (kMaxNodes: at most 32 a
# thread)
SCAN_THREADS = 512
SCAN_MAX_NODES = SCAN_THREADS * 32
# the shared memory an H100 block can use, less room for the scan kernels'
# static arrays (about 5 KiB); and the bytes up to which sp_weights1 keeps
# two steps of bitmaps in it (scan_loop.cuh kFastBitmapBytes)
SHARED_MAX = 232448
_SCAN_STATIC = 8192
_FAST_BITMAP_BYTES = 32768


def scan_smem_bytes(N: int, R: int, K: int, B: int, spread: tuple | None = None) -> int:
    """The greedy scan's dynamic shared memory (scan_loop.cuh
    ``scan_smem``): with ``spread`` = (C slots, D domains), the spread
    region (a copy of the C slot weights for each of the block's warps,
    then, unless the bitmaps live in global memory, two steps' bitmaps of
    every slot when they fit in _FAST_BITMAP_BYTES, else one bitmap); the
    params table (3R + 2B int64), three staged pods (``stage_words``
    int64 each) and N base scores, each region from a 16-byte boundary."""
    def r16(x):
        return (x + 15) // 16 * 16

    region = 0
    if spread is not None:
        C, D = spread
        W = (D + 31) // 32
        bitmaps = 0
        if not _spread_smem(C, D)[1]:
            bitmaps = 8 * C * W if 8 * C * W <= _FAST_BITMAP_BYTES else 4 * W
        region = r16(8 * C * (SCAN_THREADS // 32) + bitmaps)
    stage_words = 2 * R + 3 + (K + 7) // 8
    return region + r16(8 * (3 * R + 2 * B)) + 8 * 3 * stage_words + 8 * N


def _scan_smem(b: rt.DeviceBatch, p: rt.ScoreParams, where: str) -> int:
    """``scan_smem_bytes`` of batch ``b``; raises when the block cannot take
    the batch: more than SCAN_MAX_NODES nodes, or more shared memory than
    an H100 block has."""
    N, R = b.alloc.shape
    if N > SCAN_MAX_NODES:
        raise ValueError(f"{where}: N={N} nodes, one scan block takes at most {SCAN_MAX_NODES}")
    sp = b.spread
    smem = scan_smem_bytes(N, R, b.port_conflict.shape[0], len(p.shape_x),
                           None if sp is None else (sp.sig_idx.shape[1],
                                                    sp.domain_present.shape[1]))
    if smem > SHARED_MAX - _SCAN_STATIC:
        raise ValueError(f"{where}: {smem} bytes of shared memory, a block has "
                         f"{SHARED_MAX - _SCAN_STATIC} beside the scan's static arrays")
    return smem


def _raise_on(lib: ctypes.CDLL, name: str, code: int, kernel: str | None = None) -> None:
    if code != 0:
        msg = getattr(lib, f"kt_{name}_error")(code).decode()
        raise RuntimeError(f"{kernel or name} launch failed: {msg} (cudaError {code})")


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index`` as a handle (what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    building a Stream object, which costs a per-round launch several
    microseconds)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _batch_args(b: rt.DeviceBatch, p: rt.ScoreParams) -> ScoreArgs:
    """The argument struct of ``b`` against its own node state, every
    nomination charged, a spread bitmap row a pod (``_score_args``), packed
    at its first use and then kept on the batch object with the tensors it
    points to: the cycle's ``filter_score`` launch (the greedy engine's),
    its flight-recorder explain and component masks share one struct. The
    kernels that take it write only its scratch (the affinity row totals,
    the spread sums, minMatch and bitmaps), which each launch recomputes
    before it reads it; every launch is on one stream."""
    cache = getattr(b, "_kernel_args", None)
    if cache is None:
        cache = {}
        object.__setattr__(b, "_kernel_args", cache)
    got = cache.get(p)
    if got is None:
        got = cache[p] = _score_args(b, p, "filter_score", bits_blocks=b.requests.shape[0])
    return got[0]


def _filter_score(b: rt.DeviceBatch, p: rt.ScoreParams, want_total: bool,
                  dynamic: bool = True, nom_active: torch.Tensor | None = None):
    """Launch ``filter_score``: ``(mask, base, total)``, ``base`` None and
    ``total`` the normalized total with ``want_total`` (then the normalize
    pass runs too), else ``total`` None. Without ``dynamic`` the mask
    leaves out the InterPodAffinity and PodTopologySpread filters (the ones
    that move with each assignment). ``nom_active``: the live nominations
    (all when None: the batch's own struct, ``_batch_args``). The batch's
    pod classes (``runtime.pod_classes``) are scored once a class."""
    keep = None
    if nom_active is None:
        a = _batch_args(b, p)
    else:
        a, keep = _score_args(b, p, "filter_score", bits_blocks=b.requests.shape[0],
                              nom_active=nom_active)
    out = _launch_filter_score(a, b.alloc.device, want_total, dynamic, _smem(b),
                               rt.pod_classes(b))
    del keep
    return out


def _class_args(classes: "rt.PodClasses | None", P: int, dev) -> tuple:
    """``kt_filter_score``'s class arguments ``(reps, rep_of, C)``: nulls
    and P when every pod is a class of its own."""
    if classes is None or not classes.shared:
        return None, None, P
    if len(classes.class_of) != P:
        raise ValueError(f"filter_score: classes of {len(classes.class_of)} pods, P={P}")
    C = classes.count
    return (_check("classes.reps", classes.reps, torch.int32, (C,), dev),
            _check("classes.rep_of", classes.rep_of, torch.int32, (P,), dev), C)


def _launch_filter_score(a: ScoreArgs, dev, want_total: bool, dynamic: bool,
                         smem: int, classes: "rt.PodClasses | None" = None):
    """``_filter_score`` on packed arguments (the caller keeps their
    tensors alive); ``smem`` is the normalize pass's dynamic shared
    memory, ``classes`` the batch's pod classes (None: pod by pod). With
    ``want_total`` the base is the normalize pass's scratch (the other
    pods of a class get no base rows) and is not returned."""
    lib = build()["filter_score"]
    mask = torch.empty((a.P, a.N), dtype=torch.bool, device=dev)
    base = torch.empty((a.P, a.N), dtype=torch.int64, device=dev)
    total = (
        torch.empty((a.P, a.N), dtype=torch.int64, device=dev)
        if want_total else None
    )
    code = lib.kt_filter_score(
        ctypes.byref(a), mask.data_ptr(), base.data_ptr(),
        None if total is None else total.data_ptr(), int(dynamic), 0, smem,
        *_class_args(classes, a.P, dev), _raw_stream(dev.index))
    _raise_on(lib, "filter_score", code)
    launch_counts["filter_score"] += 1
    return mask, None if want_total else base, total


def filter_score(b: rt.DeviceBatch, p: rt.ScoreParams):
    """The ``filter_score`` kernel: ``(mask (P,N) bool, total (P,N) int64)``,
    equal to ``runtime.feasible_and_scores(b, p)``."""
    mask, _, total = _filter_score(b, p, want_total=True)
    return mask, total


def potential_mask(view: rt.DeviceBatch, p: rt.ScoreParams, requested, pod_count,
                   node_ports, spread_counts=None, pa_sums=None, nom_active=None):
    """``filter_score``'s potential mode on a one-pod view (the preemption
    evaluator's ``_potential_mask``): the (N,) bool mask of nodes where
    every victim-independent filter (static row, PodTopologySpread,
    InterPodAffinity) passes and NodeResourcesFit or NodePorts fails,
    against ``requested`` / ``pod_count`` / ``node_ports`` (bool) and the
    post-batch ``spread_counts`` / ``pa_sums`` / ``nom_active``. Equal to
    the plain composition of ``runtime.filter_components`` the evaluator
    runs on the CPU."""
    if view.requests.shape[0] != 1:
        raise ValueError(f"potential_mask: a one-pod view, got P={view.requests.shape[0]}")
    state = (requested, view.nonzero_requested, pod_count, node_ports, pa_sums,
             spread_counts)
    a, keep = _score_args(view, p, "potential_mask", state, nom_active=nom_active)
    dev = view.alloc.device
    lib = build()["filter_score"]
    mask = torch.empty((1, a.N), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.kt_filter_score(ctypes.byref(a), mask.data_ptr(), None, None, 1, 1, 0, None,
                               None, 1, stream)
    _raise_on(lib, "filter_score", code)
    launch_counts["filter_score"] += 1
    del keep
    return mask[0]


def sharded_potential_mask(views, mesh, p: rt.ScoreParams, states, nom_actives):
    """``potential_mask`` over a node mesh: ``views`` the one-pod views of
    one pod row's node columns (``mesh`` the row's node-axis mesh),
    ``states`` each column's ``(requested, pod_count, node_ports (bool),
    spread_counts, pa_sums)`` (the last two None without their leaves),
    ``nom_actives`` each column's live nominations (or None). Each shard's
    partial spread domain sums (``kt_filter_score_shard`` step 0) are summed
    over the shards (``shard_combine``), so that the spread filter on every
    shard reads the constraint's global minimum; then each shard's potential
    pass (step 1). Returns each shard's (N / G,) bool mask, equal to its
    rows of the unsharded ``potential_mask``."""
    lib = build()["filter_score"]
    shards = []
    sp = views[0].spread
    for view, (req, pc, ports, sp_counts, pa_sums), nom in zip(views, states, nom_actives):
        if view.requests.shape[0] != 1:
            raise ValueError(f"sharded_potential_mask: one-pod views, got "
                             f"P={view.requests.shape[0]}")
        dev = view.alloc.device
        with on_device(dev):
            a, keep = _score_args(view, p, "potential_mask (sharded)",
                                  (req, view.nonzero_requested, pc, ports, pa_sums, sp_counts),
                                  nom_active=nom)
            sums = None
            if sp is not None:
                # the spread domain sums the pass reads: step 0's partials,
                # then their sum over the shards
                sums = torch.empty((sp.domain_present.shape[0], sp.domain_present.shape[1] + 1),
                                   dtype=torch.int64, device=dev)
                a.sp_sums = sums.data_ptr()
            mask = torch.empty((1, a.N), dtype=torch.bool, device=dev)
        shards.append((dev, a, keep, sums, mask))

    def step(k):
        for dev, a, _, _, mask in shards:
            with on_device(dev):
                code = lib.kt_filter_score_shard(
                    ctypes.byref(a), mask.data_ptr(), None, None, k, 1, None, None, None, 0,
                    None, None, 1, _raw_stream(dev.index))
            _raise_on(lib, "filter_score", code, "filter_score (sharded potential)")
            launch_counts["filter_score"] += 1

    if sp is not None:
        step(0)
        parts = []
        for dev, _, _, sums, _ in shards:
            with on_device(dev):
                parts.append(sums.clone())
        shard_combine(mesh, SUM, parts, [x[3] for x in shards])
    step(1)
    return [x[4][0] for x in shards]


def greedy_scan(b: rt.DeviceBatch, p: rt.ScoreParams):
    """The greedy engine on the card: ``filter_score`` scores every pair
    against the batch's starting state (its mask without the affinity and
    spread filters), then the ``greedy_scan`` kernel walks the pods. Returns
    ``(assignments (P,) int32, final_state)`` with the reference's seven
    state slots (slot 4 the spread counts, None without a spread leaf; slot
    5 the affinity sums, None without affinity rows; slot 6 None), equal to
    ``assign.greedy.greedy_assign_plain(b, p)``."""
    dev = b.alloc.device
    smem = _scan_smem(b, p, "greedy_scan")
    nom_active = (
        None if b.nominated_pod_idx is None
        else torch.ones((b.nominated_pod_idx.shape[0],), dtype=torch.bool, device=dev)
    )
    # every nomination charged, as the scan starts
    mask0, base0, _ = _filter_score(b, p, want_total=False, dynamic=False)
    a, keep = _score_args(b, p, "greedy_scan", bits_blocks=1, nom_active=nom_active)
    lib = build()["greedy_scan"]
    assignments = torch.empty((a.P,), dtype=torch.int32, device=dev)
    req = torch.empty_like(b.requested)
    nz = torch.empty_like(b.nonzero_requested)
    pc = torch.empty_like(b.pod_count)
    ports = torch.empty_like(b.node_ports)
    touched = torch.empty((a.N,), dtype=torch.uint8, device=dev)
    pa = b.podaffinity
    pa_sums = None if pa is None else torch.empty_like(pa.base_sums)
    row_total = None if pa is None else torch.empty(
        (pa.base_sums.shape[0],), dtype=torch.int64, device=dev)
    sp = b.spread
    sp_counts = None if sp is None else torch.empty_like(sp.node_count)
    ok_buf = None if sp is None else torch.empty((a.N,), dtype=torch.uint8, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.kt_greedy_scan(
        ctypes.byref(a), mask0.data_ptr(), base0.data_ptr(), touched.data_ptr(),
        assignments.data_ptr(), req.data_ptr(), nz.data_ptr(), pc.data_ptr(),
        ports.data_ptr(), ptr(pa_sums), ptr(row_total), ptr(sp_counts),
        ptr(ok_buf), smem, stream)
    _raise_on(lib, "greedy_scan", code)
    launch_counts["greedy_scan"] += 1
    del keep
    return assignments, (req, nz, pc, ports, sp_counts, pa_sums, nom_active)


def _hypothesis_scan(b: rt.DeviceBatch, p: rt.ScoreParams, masks: torch.Tensor,
                     freed_req: torch.Tensor | None, freed_count: torch.Tensor | None,
                     where: str):
    """Launch ``filter_score`` once on the batch, then the ``hypothesis_scan``
    kernel over the H rows of ``masks`` (H, N) bool, each hypothesis with
    its freed rows when ``freed_req`` (H, N, R) int64 / ``freed_count`` (H,
    N) int32 are given. Returns ``(assignments (H, P) int32, counts (H,)
    int32, alignment (H,) int32)``, fresh tensors."""
    dev = b.alloc.device
    N, R = b.alloc.shape
    H = masks.shape[0] if masks.dim() == 2 else -1
    p_mask = _check("masks", masks, torch.bool, (H, N), dev)
    p_freed = p_count = None
    if (freed_req is None) != (freed_count is None):
        raise ValueError(f"{where}: freed_req and freed_count come together")
    if freed_req is not None:
        p_freed = _check("freed_req", freed_req, torch.int64, (H, N, R), dev)
        p_count = _check("freed_count", freed_count, torch.int32, (H, N), dev)
    smem = _scan_smem(b, p, where)
    # every nomination charged: the scans start with all of them live
    mask0, base0, _ = _filter_score(b, p, want_total=False, dynamic=False)
    a, keep = _score_args(b, p, where, bits_blocks=H)
    G = a.G
    P, K = a.P, a.K
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    if G:
        nom_active = torch.ones((H, G), dtype=torch.bool, device=dev)
        keep.append(nom_active)
        a.nom_active = nom_active.data_ptr()
    pa, sp, topo = b.podaffinity, b.spread, b.topology
    pa_sums = row_total = sp_counts = ok_buf = None
    if pa is not None:
        RA, D = pa.base_sums.shape
        pa_sums = torch.empty((H, RA, D), dtype=i64, device=dev)
        row_total = torch.empty((H, RA), dtype=i64, device=dev)
    if sp is not None:
        S, D = sp.domain_present.shape
        sp_counts = torch.empty((H, S, N), dtype=i32, device=dev)
        ok_buf = torch.empty((H, N), dtype=u8, device=dev)
        sums = torch.empty((H, S, D + 1), dtype=i64, device=dev)
        min_match = torch.empty((H, S), dtype=i64, device=dev)
        keep += [sums, min_match]
        a.sp_sums, a.sp_min_match = sums.data_ptr(), min_match.data_ptr()
    slice_id = slice_buf = None
    num_slices = 0
    if topo is not None:
        num_slices = int(topo.num_slices)
        slice_id = topo.slice_id
        _check("topology.slice_id", slice_id, i32, (N,), dev)
        need = 4 * (num_slices + 1)
        if need <= _SMEM_LIMIT:
            smem = max(smem, need)
        else:
            slice_buf = torch.empty((H, num_slices + 1), dtype=i32, device=dev)
    assignments = torch.empty((H, P), dtype=i32, device=dev)
    counts = torch.empty((H,), dtype=i32, device=dev)
    align = torch.empty((H,), dtype=i32, device=dev)
    scratch = (
        torch.empty((H, N), dtype=u8, device=dev),               # touched
        torch.empty((H, N, R), dtype=i64, device=dev),           # req
        torch.empty((H, N, R), dtype=i64, device=dev),           # nz
        torch.empty((H, N), dtype=i32, device=dev),              # pc
        torch.empty((H, N, K), dtype=torch.bool, device=dev),    # ports
    )

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = build()["hypothesis_scan"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.kt_hypothesis_scan(
        ctypes.byref(a), mask0.data_ptr(), base0.data_ptr(), p_mask, p_freed, p_count,
        scratch[0].data_ptr(), assignments.data_ptr(), *(x.data_ptr() for x in scratch[1:]),
        ptr(pa_sums), ptr(row_total), ptr(sp_counts), ptr(ok_buf), ptr(slice_id),
        num_slices, ptr(slice_buf), counts.data_ptr(), align.data_ptr(), H, smem, stream)
    _raise_on(lib, "hypothesis_scan", code)
    launch_counts["hypothesis_scan"] += 1
    del keep
    return assignments, counts, align


def placement_scan(b: rt.DeviceBatch, p: rt.ScoreParams, masks: torch.Tensor):
    """The placement search on the card (B11 on the greedy engine, with B12
    fused): ``filter_score`` once, then one ``hypothesis_scan`` launch over
    the D placement masks (D, N) bool, each hypothesis scanning the batch
    under ``node_valid & masks[d]``. Returns ``(assignments (D, P) int32,
    counts (D,) int32, alignment (D,) int32)``, equal to
    ``assign.placement.placement_assign_plain(b, p, masks)``."""
    return _hypothesis_scan(b, p, masks, None, None, "placement_scan")


def gang_dry_run_scan(b: rt.DeviceBatch, p: rt.ScoreParams, masks: torch.Tensor,
                      freed_req: torch.Tensor, freed_count: torch.Tensor):
    """The gang dry run on the card (B13 on the greedy engine, with B12
    fused): one ``hypothesis_scan`` launch over C eviction hypotheses, each
    scanning the batch under ``node_valid & masks[c]`` from the node state
    less ``freed_req[c]`` (C, N, R) int64 and ``freed_count[c]`` (C, N)
    int32, clamped at 0. Returns ``(counts (C,) int32, alignment (C,)
    int32)``, equal to ``ops.preemption.dry_run_gang_preemption_plain(b, p,
    masks, freed_req, freed_count)``."""
    _, counts, align = _hypothesis_scan(b, p, masks, freed_req, freed_count,
                                        "gang_dry_run_scan")
    return counts, align


def hypothesis_rows(b: rt.DeviceBatch, masks: torch.Tensor,
                    freed_req: torch.Tensor | None = None,
                    freed_count: torch.Tensor | None = None):
    """The ``hypothesis_rows`` kernel: every hypothesis's node rows at once
    for the batched engine's hypotheses. Returns ``(valid (H, N) bool, req
    (H, N, R) int64, nz (H, N, R) int64, pc (H, N) int32)``: ``valid[h] =
    node_valid & masks[h]`` and, when ``freed_req`` (H, N, R) int64 /
    ``freed_count`` (H, N) int32 are given, ``requested``,
    ``nonzero_requested`` and ``pod_count`` less the freed rows, clamped at
    0 (else the last three are None). Equal to the rows
    ``assign.placement.run_hypotheses`` builds."""
    dev = b.alloc.device
    if dev.type != "cuda":
        raise ValueError(f"hypothesis_rows: the kernel takes CUDA tensors, batch is on {dev}")
    N, R = b.alloc.shape
    H = masks.shape[0] if masks.dim() == 2 else -1
    p_mask = _check("masks", masks, torch.bool, (H, N), dev)
    if (freed_req is None) != (freed_count is None):
        raise ValueError("hypothesis_rows: freed_req and freed_count come together")
    p_valid = _check("node_valid", b.node_valid, torch.bool, (N,), dev)
    valid = torch.empty((H, N), dtype=torch.bool, device=dev)
    req = nz = pc = None
    ptrs = [None] * 5
    if freed_req is not None:
        ptrs = [
            _check("requested", b.requested, torch.int64, (N, R), dev),
            _check("nonzero_requested", b.nonzero_requested, torch.int64, (N, R), dev),
            _check("pod_count", b.pod_count, torch.int32, (N,), dev),
            _check("freed_req", freed_req, torch.int64, (H, N, R), dev),
            _check("freed_count", freed_count, torch.int32, (H, N), dev),
        ]
        req = torch.empty((H, N, R), dtype=torch.int64, device=dev)
        nz = torch.empty((H, N, R), dtype=torch.int64, device=dev)
        pc = torch.empty((H, N), dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = build()["hypothesis_scan"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.kt_hypothesis_rows(H, N, R, p_valid, p_mask, *ptrs, valid.data_ptr(),
                                  ptr(req), ptr(nz), ptr(pc), stream)
    _raise_on(lib, "hypothesis_scan", code, "hypothesis_rows")
    launch_counts["hypothesis_rows"] += 1
    return valid, req, nz, pc


def slice_epilogue(assignments: torch.Tensor, pod_valid: torch.Tensor,
                   slice_id: torch.Tensor | None, num_slices: int):
    """The ``slice_epilogue`` kernel over H finished assignment rows
    (H, P) int32 (one block a row, the ``hypothesis_scan`` epilogue):
    ``(counts (H,) int32, alignment (H,) int32)`` — each row's assigned
    valid pods and Σ c_s² over its labeled slices (``slice_id`` (N,)
    int32, None for no topology leaf: alignment 0). Equal to the counts
    and ``ops.topology.alignment_score`` of each row."""
    dev = assignments.device
    if dev.type != "cuda":
        raise ValueError(f"slice_epilogue: the kernel takes CUDA tensors, got {dev}")
    H, P = assignments.shape if assignments.dim() == 2 else (-1, -1)
    p_assign = _check("assignments", assignments, torch.int32, (H, P), dev)
    p_pod = _check("pod_valid", pod_valid, torch.bool, (P,), dev)
    smem, slice_buf, p_slice = 0, None, None
    if slice_id is None:
        num_slices = 0
    else:
        p_slice = _check("slice_id", slice_id, torch.int32, (slice_id.shape[0],), dev)
        need = 4 * (num_slices + 1)
        if need <= _SMEM_LIMIT:
            smem = need
        else:
            slice_buf = torch.empty((H, num_slices + 1), dtype=torch.int32, device=dev)
    counts = torch.empty((H,), dtype=torch.int32, device=dev)
    align = torch.empty((H,), dtype=torch.int32, device=dev)
    lib = build()["hypothesis_scan"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.kt_slice_epilogue(
        H, P, p_pod, p_assign, p_slice, num_slices,
        None if slice_buf is None else slice_buf.data_ptr(), counts.data_ptr(),
        align.data_ptr(), smem, stream)
    _raise_on(lib, "hypothesis_scan", code, "slice_epilogue")
    launch_counts["slice_epilogue"] += 1
    return counts, align


def batched_hypotheses(b: rt.DeviceBatch, p: rt.ScoreParams, masks: torch.Tensor,
                       freed_req: torch.Tensor | None = None,
                       freed_count: torch.Tensor | None = None):
    """B11 / B13 on the batched engine: ``hypothesis_rows`` once, the
    batched engine (one ``batched_round`` solve) once a hypothesis on its
    rows, then ``slice_epilogue`` once over the (H, P)
    assignments. Returns ``(assignments (H, P) int32, counts (H,) int32,
    alignment (H,) int32)``, equal to ``assign.placement.run_hypotheses``
    with the plain batched engine."""
    valid, req, nz, pc = hypothesis_rows(b, masks, freed_req, freed_count)
    H, P = valid.shape[0], b.requests.shape[0]
    assignments = torch.empty((H, P), dtype=torch.int32, device=b.alloc.device)
    for h in range(H):
        nodes = dataclasses.replace(b.nodes, node_valid=valid[h])
        if req is not None:
            nodes = dataclasses.replace(nodes, requested=req[h], nonzero_requested=nz[h],
                                        pod_count=pc[h])
        assignments[h], _ = batched_assign(rt.with_nodes(b, nodes), p)
    topo = b.topology
    counts, align = slice_epilogue(
        assignments, b.pod_valid, None if topo is None else topo.slice_id,
        0 if topo is None else int(topo.num_slices))
    return assignments, counts, align


def batched_assign(b: rt.DeviceBatch, p: rt.ScoreParams, max_rounds: int = 0,
                   rounds_out: list | None = None):
    """The batched engine on the card (kernel B6): one launch a solve
    (``kt_batched_round``: the rounds, each with its Filter + Score of every
    pod class against the round's state, its choice, admissions and commit,
    and the stop rule on the device, every SM's block on the batch), then
    one read of the rounds. The batch's node block is not written. Returns
    ``(assignments (P,) int32, final_state)`` with the seven state slots,
    equal to ``assign.batched.batched_assign_plain(b, p, max_rounds)``;
    ``rounds_out``, when given, receives the number of rounds."""
    dev = b.alloc.device
    _require_cuda(dev, "batched_round")
    P = b.requests.shape[0]
    if P > 1024:
        raise ValueError(f"batched_round: P={P} exceeds the solve's 1024 pods")
    cards = {dev: [0]}
    bpt = _blocks_a_tile(cards)
    with on_device(dev):
        tile = _BatchTile(b, b, p, 0, 0, 0, 1)
    rounds = _solve([tile], cards, 1, 1, bpt, max_rounds or P, None, "batched_round",
                    "batched_round", batched_split)
    if rounds_out is not None:
        rounds_out.append(rounds)
    return tile.assignments, _seven(tile.state, tile.nom_active)


def _r16(x: int) -> int:
    return (x + 15) // 16 * 16


# each node field's dtype and whether its row holds R values
_NODE_ROWS = {
    "alloc": (torch.int64, True), "requested": (torch.int64, True),
    "nonzero_requested": (torch.int64, True), "pod_count": (torch.int32, False),
    "allowed_pods": (torch.int32, False), "node_valid": (torch.bool, False),
}


class ScatterLaunch:
    """Kernel B5's launch plan for one node block (``runtime.ScatterPlan``
    holds one for a block on the card): the block's six buffers, N and R,
    validated once, as the ``ScatterPlan`` struct the kernel takes, with
    the entry point and the block's card; and, for each delta size M, the
    offsets of the six update rows from the index in ``upload_packed``'s
    layout."""

    def __init__(self, nodes: rt.DeviceNodeState) -> None:
        dev = nodes.alloc.device
        _require_cuda(dev, "scatter_rows")
        N, R = nodes.alloc.shape
        self.dev, self.R = dev, R
        self.args = ScatterPlanArgs(*(
            _check(name, getattr(nodes, name), dtype, (N, R) if wide else (N,), dev)
            for name, (dtype, wide) in _NODE_ROWS.items()), N, R)
        # the buffers the struct points to live as long as the plan
        self.nodes = nodes
        self.fn = build()["scatter_rows"].kt_scatter_rows
        self.layouts: dict = {}

    def layout(self, M: int):
        """The six update rows' byte offsets from the index of an M-slot
        delta packed by ``runtime.upload_packed`` in ``DELTA_FIELDS`` order
        (each array from a 16-byte boundary), as the kernel's int64[6]."""
        got = self.layouts.get(M)
        if got is None:
            sizes = [4 * M] + [
                (8 * M * self.R if wide else M * dtype.itemsize)
                for dtype, wide in _NODE_ROWS.values()]
            offs, at = [], 0
            for size in sizes[:-1]:
                at += _r16(size)
                offs.append(at)
            got = self.layouts[M] = (ctypes.c_int64 * 6)(*offs)
        return got

    def scatter(self, tensors) -> None:
        """The ``scatter_rows`` kernel on a shipped delta: ``tensors`` the
        ``runtime.DELTA_FIELDS`` views of one ``upload_packed`` buffer on
        the plan's card (the index, then the six update rows, each from a
        16-byte boundary). Only the delta is checked: the index (int32,
        (M,)), that the buffer holds every row the layout reads, and that
        each update view starts where the layout puts it. One launch;
        entries of the index outside ``[0, N)`` are dropped."""
        idx = tensors[rt.DELTA_FIELDS[0]]
        if idx.device != self.dev or idx.dtype != torch.int32 or idx.dim() != 1:
            raise ValueError(f"scatter_rows: the delta's index is {idx.dtype} "
                             f"{tuple(idx.shape)} on {idx.device}, the plan takes int32 (M,) "
                             f"on {self.dev}")
        M = idx.shape[0]
        offsets = self.layout(M)
        base = idx.data_ptr()
        store = idx.untyped_storage()
        if base + offsets[5] + M > store.data_ptr() + store.nbytes():
            raise ValueError(f"scatter_rows: the delta's buffer ends before its "
                             f"{rt.DELTA_FIELDS[-1]} row")
        for name, off in zip(rt.DELTA_FIELDS[1:], offsets):
            if tensors[name].data_ptr() != base + off:
                raise ValueError(f"scatter_rows: {name} is not where the packed layout puts it")
        code = self.fn(ctypes.byref(self.args), base, offsets, M, _raw_stream(self.dev.index))
        _raise_on(_libs["scatter_rows"], "scatter_rows", code)
        launch_counts["scatter_rows"] += 1


def dry_run_preemption(pod_req, pod_prio, wants_conf, potential, alloc, requested,
                       pod_count, allowed, port_counts, v_valid, v_prio, v_start,
                       v_req, v_ports, v_pdb, pdb_allowed):
    """The ``dry_run_preemption`` kernel (B9): the victim search on every
    node and the pick of one, in one launch. Same arguments and results as
    ``ops.preemption.dry_run_preemption_plain``: ``(node_idx () int32,
    victims (N, K) bool, ok (N,) bool, n_pdb (N,) int64)``, fresh tensors.
    ``pod_prio`` is an int (or a one-element tensor)."""
    return _dry_run(pod_req, pod_prio, wants_conf, potential, alloc, requested, pod_count,
                    allowed, port_counts, v_valid, v_prio, v_start, v_req, v_ports, v_pdb,
                    pdb_allowed)[:4]


# B9's block: at most this many warps, one a node (dry_run_preemption.cu
# kMaxWarps), in the dynamic shared memory a block takes without opting in
# (kDefaultSmem) unless one node needs more; a candidate node's six int64
# keys
_DRY_MAX_WARPS = 8
_DRY_SMEM = 48 * 1024 - 1024
_CAND_BYTES = 48
_dry_layouts: dict = {}


def dry_run_layout(K: int, R: int, Kp: int, D: int) -> tuple[int, int, int]:
    """B9's block for K slots, R resources, Kp triples and D PDBs: ``(warps,
    stage, smem)``, as many nodes (warps) as ``_DRY_SMEM`` holds, at most
    ``_DRY_MAX_WARPS``, each with its slots' rows staged in shared memory
    (``stage`` 1); a node that needs more takes a block alone, opting in to
    more shared memory, and where its staged rows do not fit even then
    they are read from global memory (``stage`` 0). ``smem`` is the
    block's dynamic shared memory (``kt_dry_run_preemption_smem``). Raises
    when a node's ranks and running state alone do not fit a block."""
    key = (K, R, Kp, D)
    got = _dry_layouts.get(key)
    if got is None:
        size = build()["dry_run_preemption"].kt_dry_run_preemption_smem
        limit = SHARED_MAX - 1024   # the kernel's static arrays take ~400 bytes
        one, base = size(K, R, Kp, D, 1, 1), size(K, R, Kp, D, 1, 0)
        stage = 1 if one <= limit else 0
        if not stage:
            base = size(K, R, Kp, D, 0, 0)
            one = size(K, R, Kp, D, 0, 1)
            if one > limit:
                raise ValueError(f"dry_run_preemption: K={K} slots need {one} bytes of shared "
                                 f"memory for one node, a block has {limit}")
        warps = max(1, min(_DRY_MAX_WARPS, (_DRY_SMEM - base) // (one - base)))
        got = _dry_layouts[key] = (warps, stage, size(K, R, Kp, D, stage, warps))
    return got


def _dry_run(pod_req, pod_prio, wants_conf, potential, alloc, requested,
             pod_count, allowed, port_counts, v_valid, v_prio, v_start,
             v_req, v_ports, v_pdb, pdb_allowed):
    """``dry_run_preemption``, also returning the chosen node's keys, the
    (6,) int64 ``best`` (n_pdb, max priority, summed priority, victims,
    earliest start, node; node -1 for none) that K3 reads. The outputs are
    views of one allocation: n_pdb, best, the blocks' bests, the ticket,
    node_idx, victims, ok, each from a 16-byte boundary."""
    dev = potential.device
    if dev.type != "cuda":
        raise ValueError(f"dry_run_preemption: the kernel takes CUDA tensors, got {dev}")
    i64, i32, u8 = torch.int64, torch.int32, torch.bool
    N, K = v_valid.shape
    R = alloc.shape[1]
    Kp = port_counts.shape[1]
    D = pdb_allowed.shape[0]
    a = DryRunArgs()
    a.pod_req = _check("pod_req", pod_req, i64, (R,), dev)
    a.wants_conf = _check("wants_conf", wants_conf, u8, (Kp,), dev)
    a.potential = _check("potential", potential, u8, (N,), dev)
    a.alloc = _check("alloc", alloc, i64, (N, R), dev)
    a.requested = _check("requested", requested, i64, (N, R), dev)
    a.pod_count = _check("pod_count", pod_count, i32, (N,), dev)
    a.allowed = _check("allowed", allowed, i32, (N,), dev)
    a.port_counts = _check("port_counts", port_counts, i32, (N, Kp), dev)
    a.v_valid = _check("v_valid", v_valid, u8, (N, K), dev)
    a.v_prio = _check("v_prio", v_prio, i64, (N, K), dev)
    a.v_start = _check("v_start", v_start, i64, (N, K), dev)
    a.v_req = _check("v_req", v_req, i64, (N, K, R), dev)
    a.v_ports = _check("v_ports", v_ports, torch.int8, (N, K, Kp), dev)
    a.v_pdb = _check("v_pdb", v_pdb, u8, (N, K, D), dev)
    a.pdb_allowed = _check("pdb_allowed", pdb_allowed, i64, (D,), dev)
    warps, stage, smem = dry_run_layout(K, R, Kp, D)
    blocks = -(-N // warps)
    sizes = (8 * N, _CAND_BYTES, _CAND_BYTES * blocks, 4, 4, N * K, N)
    offs = [0]
    for size in sizes:
        offs.append(offs[-1] + _r16(size))
    buf = torch.empty((offs[-1] // 8,), dtype=i64, device=dev)
    base = buf.data_ptr()
    a.n_pdb, a.best, a.parts, a.ticket, a.node_idx, a.victims, a.ok = (
        base + o for o in offs[:-1])
    a.pod_prio = int(pod_prio)
    a.N, a.K, a.R, a.Kp, a.D = N, K, R, Kp, D
    a.warps, a.stage, a.smem = warps, stage, smem
    lib = build()["dry_run_preemption"]
    code = lib.kt_dry_run_preemption(ctypes.byref(a), _raw_stream(dev.index))
    _raise_on(lib, "dry_run_preemption", code)
    launch_counts["dry_run_preemption"] += 1
    flags = buf.view(u8)
    return (buf.view(i32)[offs[4] // 4],
            flags.as_strided((N, K), (K, 1), offs[5]),
            flags[offs[6]:offs[6] + N],
            buf[:N],
            buf[offs[1] // 8:offs[1] // 8 + 6])


def _component_flags(b: rt.DeviceBatch, p: rt.ScoreParams) -> list[bool]:
    """Which of ``runtime.filter_components(b, p)[:5]`` (static, fit,
    ports_ok, spread_ok, pa_ok) are present, i.e. not None."""
    sp, pa = b.spread, b.podaffinity
    return [
        True,
        bool(p.filter_fit),
        bool(p.filter_ports),
        sp is not None and bool(p.filter_spread and sp.has_hard),
        pa is not None and bool(p.filter_interpod and pa.has_filter_work),
    ]


# pass (e) of explain_summary.cu: threads a block (kTileThreads), and the
# blocks a card's SM should hold over every class's tiles
_EXPLAIN_THREADS = 128
_EXPLAIN_BLOCKS_AN_SM = 16


def explain_tile_width(C: int, N: int, sms: int) -> int:
    """The nodes a tile of the explain's pass (e) takes over C classes of N
    nodes on a card of ``sms`` SMs: tiles enough that the C classes' tiles
    fill the card (``_EXPLAIN_BLOCKS_AN_SM`` blocks an SM), none narrower
    than a block's threads."""
    tiles = max(1, min(-(-N // _EXPLAIN_THREADS), -(-_EXPLAIN_BLOCKS_AN_SM * sms // C)))
    return -(-N // tiles)


def _explain_scratch(C: int, N: int, T: int) -> int:
    """Bytes of ``kt_explain_summary``'s scratch: the (C, N) mask, the (C,
    N) int64 base and total, C x T 64-byte partials, C tickets, each from
    a 16-byte boundary (explain_summary.cu's layout)."""
    return _r16(C * N) + _r16(8 * C * N) + _r16(64 * C * T) + _r16(4 * C)


def explain_summary(b: rt.DeviceBatch, p: rt.ScoreParams, assignments: torch.Tensor):
    """The flight recorder's per-pod summary on the card (B10
    ``_explain_kernel``): one ``explain_summary`` call on the batch's pod
    classes (``runtime.pod_classes``; a class a pod without them): the
    pre-launches, the pair and normalize passes of ``filter_score`` on the
    classes' representatives into (C, N) rows, then one pass over (class,
    node tile) blocks that counts, ranks and merges, and writes every pod's
    summary; ``assignments`` (P,) int32 the engine's. The argument struct
    is the batch's own (``_batch_args``: packed by the cycle's
    ``filter_score`` launch when the engine ran one). Returns ``(feasible
    (P,) int32, reject (five (P,) int32 or None), top_vals (P, k) int64,
    top_idx (P, k) int32, win (P,) int64)``, k = min(3, N), fresh tensors;
    equal to ``sched.flightrecorder.explain_summary_plain(b, p,
    assignments)``."""
    dev = b.alloc.device
    _require_cuda(dev, "explain_summary")
    a = _batch_args(b, p)
    P, N = a.P, a.N
    idx = _check("assignments", assignments, torch.int32, (P,), dev)
    classes = rt.pod_classes(b)
    reps = class_of = None
    C = P
    if classes is not None and classes.shared:
        C = classes.count
        reps = _check("classes.reps", classes.reps, torch.int32, (C,), dev)
        class_of = _check("classes.class_idx", classes.class_idx, torch.int32, (P,), dev)
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    TW = explain_tile_width(C, N, _sm_count[dev]) if N else 1
    flags = _component_flags(b, p)
    k = min(3, N)
    scratch = torch.empty((_explain_scratch(C, N, -(-N // TW)),), dtype=torch.uint8, device=dev)
    feasible = torch.empty((P,), dtype=torch.int32, device=dev)
    reject = torch.empty((5, P), dtype=torch.int32, device=dev)
    top_vals = torch.empty((P, k), dtype=torch.int64, device=dev)
    top_idx = torch.empty((P, k), dtype=torch.int32, device=dev)
    win = torch.empty((P,), dtype=torch.int64, device=dev)
    lib = build()["explain_summary"]
    code = lib.kt_explain_summary(
        ctypes.byref(a), reps, class_of, C, idx, sum(1 << c for c, on in enumerate(flags) if on),
        k, TW, scratch.data_ptr(), _smem(b), feasible.data_ptr(), reject.data_ptr(),
        top_vals.data_ptr(), top_idx.data_ptr(), win.data_ptr(), _raw_stream(dev.index))
    _raise_on(lib, "explain_summary", code)
    launch_counts["explain_summary"] += 1
    rejects = tuple(reject[c] if on else None for c, on in enumerate(flags))
    return feasible, rejects, top_vals, top_idx, win


# the masks' bits launch (filter_component_masks.cu): its widest tile
# (kMaxTile), and the narrowest this wrapper asks for
_MASK_MAX_TILE = 2048
_MASK_MIN_TILE = 128


def mask_tile_width(C: int, N: int, sms: int) -> int:
    """The nodes a block of the masks' bits launch takes over C classes of
    N nodes on a card of ``sms`` SMs: tiles enough that the classes' tiles
    give every SM two blocks, none narrower than ``_MASK_MIN_TILE`` nodes
    or wider than ``_MASK_MAX_TILE``, a multiple of 16 (one 16-byte
    store)."""
    tiles = max(1, min(-(-N // _MASK_MIN_TILE), -(-2 * sms // max(C, 1))))
    width = -(-max(N, 1) // tiles)
    return min(_MASK_MAX_TILE, -(-width // 16) * 16)


def mask_plan(classes: "rt.PodClasses | None", rows, P: int):
    """The requested rows of the masks' launch grouped by pod class:
    ``(plan, C, U, first)``, plan the (2C + 1 + U,) int32 host array the
    kernel takes (each class's representative pod, the classes' starts
    into the rows that follow, then each class's output rows in turn), or
    None when the rows are pods ``first .. first + U - 1`` and no two of
    them share a class (one row, or a batch without shared classes): class
    j is then pod ``first + j``, written to row j. ``rows`` host ints in
    ``[0, P)``, None for all P."""
    shared = classes is not None and classes.shared
    if rows is None:
        if not shared:
            return None, P, P, 0
        plan = np.concatenate([classes.host_reps(), classes.class_start, classes.members])
        return plan.astype(np.int32), classes.count, P, 0
    U = len(rows)
    if U and (min(rows) < 0 or max(rows) >= P):
        raise ValueError(f"filter_component_masks: rows outside [0, {P})")
    first = int(rows[0]) if U else 0
    if (U <= 1 or not shared) and all(r == first + i for i, r in enumerate(rows)):
        return None, U, U, first
    if U <= 64:
        # a few rows (the recorder's unschedulable pods, the bridge's one):
        # plain Python, where numpy's fixed cost a call would dominate
        groups: dict = {}
        for u, r in enumerate(rows):
            groups.setdefault(int(classes.class_of[r]) if shared else int(r), []).append(u)
        keys = sorted(groups)
        reps = [int(classes.members[classes.class_start[c]]) if shared else c for c in keys]
        start = [0]
        for c in keys:
            start.append(start[-1] + len(groups[c]))
        pos = [u for c in keys for u in groups[c]]
        return np.array(reps + start + pos, dtype=np.int32), len(keys), U, 0
    rows = np.asarray(rows, dtype=np.int64)
    key = classes.class_of[rows] if shared else rows
    uniq, inverse = np.unique(key, return_inverse=True)
    reps = classes.host_reps()[uniq] if shared else uniq
    start = np.zeros(len(uniq) + 1, dtype=np.int64)
    np.cumsum(np.bincount(inverse, minlength=len(uniq)), out=start[1:])
    pos = np.argsort(inverse, kind="stable")
    return np.concatenate([reps, start, pos]).astype(np.int32), len(uniq), U, 0


def filter_component_masks(b: rt.DeviceBatch, p: rt.ScoreParams, rows=None):
    """The ``filter_component_masks`` kernel (B10 ``_explain_masks_kernel``,
    and the extender bridge's per-plugin masks) on the pod rows ``rows``
    (host ints; None: all P): ``(bits (U, N) uint8, present)``, bit c of
    ``bits[u, n]`` component c of ``runtime.filter_components(b, p)[:5]``
    (static, fit, ports_ok, spread_ok, pa_ok) for pod ``rows[u]`` at node
    n, fit charging every nomination, 0 where the component is absent;
    ``present`` (``_component_flags``) which are present. Each class's
    work is done once, on its representative (``mask_plan``); one
    allocation (the plan's device copy, then the bits), one call. Equal to
    ``sched.flightrecorder.filter_component_masks_rows_plain(b, p, rows)``."""
    dev = b.alloc.device
    _require_cuda(dev, "filter_component_masks")
    a = _batch_args(b, p)
    flags = _component_flags(b, p)
    plan, C, U, first = mask_plan(rt.pod_classes(b), rows, a.P)
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    if plan is None:
        out = torch.empty((U, a.N), dtype=torch.uint8, device=dev)
        plan_dev = None
    else:
        head = _r16(4 * len(plan))
        buf = torch.empty((head + U * a.N,), dtype=torch.uint8, device=dev)
        out = buf.as_strided((U, a.N), (a.N, 1), head)
        plan_dev = buf.data_ptr()
    lib = build()["filter_component_masks"]
    code = lib.kt_filter_component_masks(
        ctypes.byref(a), None if plan is None else plan.ctypes.data,
        0 if plan is None else len(plan), plan_dev, C, U, first,
        sum(1 << c for c, on in enumerate(flags) if on),
        mask_tile_width(C, a.N, _sm_count[dev]), out.data_ptr(), _raw_stream(dev.index))
    _raise_on(lib, "filter_component_masks", code)
    launch_counts["filter_component_masks"] += 1
    return out, tuple(flags)


# ------------------------------------- the solves: packing (B14), batched (B6)
def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _start_state(b: rt.DeviceBatch):
    """Copies of the batch's start state in ``_score_args`` order
    (requested, nonzero, pod_count, node_ports, pa_sums, spread_counts),
    and the live nominations (all)."""
    pa, sp = b.podaffinity, b.spread
    nom = (None if b.nominated_pod_idx is None else
           torch.ones((b.nominated_pod_idx.shape[0],), dtype=torch.bool, device=b.alloc.device))
    clone = (lambda x: None if x is None else x.clone())
    return ((b.requested.clone(), b.nonzero_requested.clone(), b.pod_count.clone(),
             b.node_ports.clone(), clone(None if pa is None else pa.base_sums),
             clone(None if sp is None else sp.node_count)), nom)


def _seven(state, nom_active):
    req, nz, pc, ports, pa_sums, sp_counts = state
    return (req, nz, pc, ports, sp_counts, pa_sums, nom_active)


class _TileBase:
    """What a tile of a solve on the card holds alike in the packing solve
    (``SolveTile``) and the batched one (``BatchTile``): its running state
    ``state`` and nominations ``nom_active``; its argument structs (``a``:
    the tile's pods against its node column over the running state; ``af``:
    the column with every pod's pod-major leaves, ``a`` itself when the
    tile holds every pod); its pod classes (``runtime.pod_classes``, on the
    device; a class a pod without them); and the sizes of its scratch
    (``parts``: name -> bytes, None for a buffer the batch does not need):
    the class rows of a round (``stats`` rows of class statistics) and the
    per-pod vectors of every pod, carved from one allocation by ``fill``.
    ``full`` is the tile's batch with every pod (``b`` on one pod row)."""

    def __init__(self, b: rt.DeviceBatch, full: rt.DeviceBatch, p: rt.ScoreParams, state,
                 nom_active, offset: int, row: int, col: int, stats: int, what: str) -> None:
        dev = b.alloc.device
        self.dev = dev
        self.state, self.nom_active = state, nom_active
        self.a, self.keep = _score_args(b, p, what, state, nom_active=nom_active)
        # the struct points into `full`'s gathered pod leaves: kept alive
        # with the tile until the launch is done
        self.full, self.af = full, self.a
        if full is not b:
            self.af, self.keep_full = _score_args(full, p, what, state, nom_active=nom_active,
                                                  pod_node=False)
        Pb, P, N = self.a.P, self.af.P, self.a.N
        cls = rt.pod_classes(b)
        if cls is not None and cls.shared:
            C = cls.count
            self.class_of = _check("classes.class_idx", cls.class_idx, torch.int32, (Pb,), dev)
            self.reps = _check("classes.reps", cls.reps, torch.int32, (C,), dev)
            self.keep_classes = cls
        else:
            # a class a pod: each pod its own class and representative
            C = Pb
            self.identity = torch.arange(Pb, dtype=torch.int32, device=dev)
            self.class_of = self.reps = self.identity.data_ptr()
        self.C = C
        sp = b.spread
        cw = 1 if sp is None else max(
            sp.sig_idx.shape[1] * ((sp.domain_present.shape[1] + 31) // 32), 1)
        self.spread_slots = 0 if sp is None else sp.sig_idx.shape[1]
        self.assignments = torch.empty((P,), dtype=torch.int32, device=dev)
        self.parts = dict(
            mask=C * N, total=8 * C * N, ties=4 * C * N, cstats=8 * stats * C, sc=16 * C,
            bits=16 * C * cw, mx=16 * C * 7, active=P, choice=4 * P, acc=4 * P,
            sums_part=None if sp is None else 8 * sp.domain_present.shape[0] * (
                sp.domain_present.shape[1] + 1))
        self.offset, self.row, self.col = offset, row, col

    def fill(self, t) -> None:
        """The struct fields both solves' tiles have, and every scratch
        buffer of ``parts`` (its fields by name), carved from one
        allocation (16-byte aligned; the solve writes each before it reads
        it)."""
        t.a, t.af = self.a, self.af
        t.class_of, t.reps, t.C = self.class_of, self.reps, self.C
        off, at = 0, {}
        for name, size in self.parts.items():
            if size is not None:
                at[name] = off
                off += (size + 15) // 16 * 16
        self.scratch = torch.empty((max(off, 16),), dtype=torch.uint8, device=self.dev)
        base = self.scratch.data_ptr()
        for name in self.parts:
            setattr(t, name, base + at[name] if name in at else None)
        req, nz, pc, ports, pa_sums, sp_counts = self.state
        t.req, t.nz, t.pc, t.ports = (x.data_ptr() for x in (req, nz, pc, ports))
        t.pa_sums, t.sp_counts = _ptr(pa_sums), _ptr(sp_counts)
        t.assignments = self.assignments.data_ptr()
        t.offset, t.row, t.col = self.offset, self.row, self.col


class _SolveTile(_TileBase):
    """One tile's buffers of a packing solve (``SolveTile``): the common
    ones over copies of the batch's start state, its (N,) duals ``lam``
    (copied), the node vectors and its outputs. ``bpt`` is the blocks the
    tile runs on."""

    def __init__(self, b: rt.DeviceBatch, full: rt.DeviceBatch, p: rt.ScoreParams,
                 lam: torch.Tensor, weights: torch.Tensor, offset: int, row: int, col: int,
                 bpt: int) -> None:
        super().__init__(b, full, p, *_start_state(b), offset, row, col, 5, "packing_round")
        dev, P, N = self.dev, self.af.P, self.a.N
        i32, f32 = torch.int32, torch.float32
        topo = b.topology
        # dynamic shared memory: the spread weights; the group keys of every
        # pod and class (at most P classes); or the picks and admission
        # order (4 bytes a pod each) with 8 warps' resource carries
        self.smem = 8 * max(2 * P, P + 8 * self.a.R, self.spread_slots)
        self.S = 0 if topo is None else int(topo.num_slices)
        self.slice_id = None if topo is None else topo.slice_id
        if self.slice_id is not None:
            _check("topology.slice_id", self.slice_id, i32, (N,), dev)
        _check("lam", lam, f32, (N,), dev)
        self.lam = lam.clone()
        self.w = weights.to(dev).contiguous()
        _check("weights", self.w, f32, (10,), dev)
        prio = full.pod_priority
        if prio is not None:
            _check("pod_priority", prio, i32, (P,), dev)
        pa_sums = self.state[4]
        self.objective = torch.empty((), dtype=f32, device=dev)
        self.nodes_used = torch.empty((), dtype=i32, device=dev)
        self.parts.update(
            busy=4 * 3 * (self.S + 1), pen=4 * N, over=4 * N, chosen=4 * N, endf=8 * bpt,
            order=4 * P, byorder=4 * P, coupled=P, scal=8 * 5,
            pa_delta=None if pa_sums is None else pa_sums.numel() * 8)
        t = self.struct = SolveTile()
        self.fill(t)
        t.lam, t.w, t.slice_id, t.S = self.lam.data_ptr(), self.w.data_ptr(), \
            _ptr(self.slice_id), self.S
        t.objective, t.nodes_used = self.objective.data_ptr(), self.nodes_used.data_ptr()
        t.req0, t.pc0, t.prio = b.requested.data_ptr(), b.pod_count.data_ptr(), _ptr(prio)


class _BatchTile(_TileBase):
    """One tile's buffers of a batched solve (``BatchTile``): the common
    ones, over running state that the solve copies from the batch's start
    state before its first round (the nominations all set); each node's
    first chooser of a round and, when the pod row has other columns
    (``NG``), the round's affinity increments."""

    def __init__(self, b: rt.DeviceBatch, full: rt.DeviceBatch, p: rt.ScoreParams,
                 offset: int, row: int, col: int, NG: int) -> None:
        pa, sp = b.podaffinity, b.spread
        empty = torch.empty_like
        state = (empty(b.requested), empty(b.nonzero_requested), empty(b.pod_count),
                 empty(b.node_ports), None if pa is None else empty(pa.base_sums),
                 None if sp is None else empty(sp.node_count))
        nom = None if b.nominated_pod_idx is None else torch.empty(
            (b.nominated_pod_idx.shape[0],), dtype=torch.bool, device=b.alloc.device)
        super().__init__(b, full, p, state, nom, offset, row, col, 4, "batched_round")
        P, N = self.af.P, self.a.N
        # dynamic shared memory: the spread weights, or the group keys of
        # every pod and class (at most P classes)
        self.smem = 8 * max(2 * P, self.spread_slots)
        self.parts.update(first=4 * N, scal=8 * 2,
                          pa_delta=None if pa is None or NG == 1 else pa.base_sums.numel() * 8)
        t = self.struct = BatchTile()
        self.fill(t)
        t.req0, t.nz0, t.pc0, t.ports0 = (x.data_ptr() for x in (
            b.requested, b.nonzero_requested, b.pod_count, b.node_ports))
        t.pa0 = None if pa is None else pa.base_sums.data_ptr()
        t.sp0 = None if sp is None else sp.node_count.data_ptr()


_sm_count: dict = {}
_solve_words: dict = {}
# when a (PACKING_SPLIT,) int64 tensor on a solve's first card, each solve
# adds to it the ns its parts took (packing_round.cu's kSplit order: the
# start, the round's steps 0-2, 3, 4, 5, 6, 7, 8, 9, 10, the end) on block
# 0's clock; a timing aid, None on every path
packing_split: "torch.Tensor | None" = None
PACKING_SPLIT = 11
# the same for the batched solve (batched_round.cu's kSplit order: the
# start, the round's steps 0-2, 3, 4, 5, 6, 7, 8, 9, the end)
batched_split: "torch.Tensor | None" = None
BATCHED_SPLIT = 10
# cudaErrorCooperativeLaunchTooLarge: the tiles' blocks cannot all be resident
_TOO_LARGE = 82


def _blocks_a_tile(cards: dict) -> int:
    """The blocks each tile of a solve runs on: the SMs of a card shared by
    the most tiles that one card holds (one block an SM)."""
    sms = []
    for card, tiles in cards.items():
        if card not in _sm_count:
            _sm_count[card] = torch.cuda.get_device_properties(card).multi_processor_count
        sms.append(_sm_count[card] // len(tiles))
    return max(min(sms), 1)


def _solve(tiles: list, cards: dict, PG: int, NG: int, bpt: int, cap: int, mesh, what: str,
           kind: str = "packing_round", split: "torch.Tensor | None" = None):
    """Launch a solve (``kind``: ``kt_packing_round`` or
    ``kt_batched_round``) over ``tiles`` (tile (i, j) at i * NG + j), one
    cooperative launch on each card of ``cards`` (card -> its tiles'
    indices), the cards' launches meeting at the mesh's exchange; then read
    each card's iterations (rounds) and error flag. ``split``: the timing
    aid's tensor (``packing_split`` / ``batched_split``) or None. Returns
    the iterations."""
    lib = build()[kind]
    Set, nsplit = (SolveSet, PACKING_SPLIT) if kind == "packing_round" else (BatchSet,
                                                                               BATCHED_SPLIT)
    base = Set()
    for i, t in enumerate(tiles):
        base.t[i] = t.struct
    base.PG, base.NG, base.bpt, base.cap = PG, NG, bpt, cap
    order = list(cards)
    slots, epoch = [], 0
    if len(order) > 1:
        ex = _mesh_exchange(mesh)
        ex.prepare(1)
        slots = [ex.slots[cards[c][0]].data_ptr() for c in order]
        epoch = ex.epoch
    smem = max(t.smem for t in tiles)
    reads = []
    for k, card in enumerate(order):
        words = _solve_words.get(card)
        if words is None:
            words = _solve_words[card] = torch.zeros(4, dtype=torch.int64, device=card)
        st = Set.from_buffer_copy(base)
        for n, i in enumerate(cards[card]):
            st.local[n] = i
        st.nlocal = len(cards[card])
        w0 = words.data_ptr()
        st.bar, st.out, st.abort = w0, w0 + 8, w0 + 24
        x = st.x
        for h, ptr in enumerate(slots):
            x.slot[h] = ptr
        x.G, x.words, x.epoch, x.budget, x.error = len(order), 0, epoch, EXCHANGE_BUDGET, w0 + 28
        st.card = k
        if k == 0 and split is not None:
            st.split = _check("split", split, torch.int64, (nsplit,), card)
        with on_device(card):
            code = getattr(lib, "kt_" + kind)(ctypes.byref(st), smem, _raw_stream(card.index))
        if code == _TOO_LARGE:
            raise RuntimeError(
                f"{what}: {len(cards[card])} tiles x {bpt} blocks of {_SOLVE_THREADS} threads "
                f"cannot all be resident on {card} (one cooperative launch holds them)")
        _raise_on(lib, kind, code, what)
        launch_counts[what] += 1
        reads.append(words[1:3])
    got = [r.tolist() for r in reads]
    if any(err for _, err in got):
        raise RuntimeError(f"{what}: a barrier or cross-card exchange waited past its budget")
    return int(got[0][0])


# the solves' block (packing_round.cu and batched_round.cu kThreads)
_SOLVE_THREADS = 256


def packing_assign(b: rt.DeviceBatch, p: rt.ScoreParams, lam: torch.Tensor,
                   weights: torch.Tensor, max_iters: int = 0):
    """The packing engine on the card (kernel B14): one launch a solve
    (``kt_packing_round``: the start, the rounds with each one's Filter +
    Score, the stop rule and the end on the device, every SM's block on the
    batch), then one read of the iterations. The batch's node block and
    ``lam`` are not written. Returns ``(assignments (P,) int32,
    final_state, lam (N,) float32, objective () float32, iters int,
    nodes_used () int32)``, equal to ``assign.packing.packing_assign_plain``
    (the objective within its float32 sums' order)."""
    dev = b.alloc.device
    _require_cuda(dev, "packing_round")
    cards = {dev: [0]}
    bpt = _blocks_a_tile(cards)
    with on_device(dev):
        tile = _SolveTile(b, b, p, lam, weights, 0, 0, 0, bpt)
    iters = _solve([tile], cards, 1, 1, bpt, max_iters or tile.a.P, None, "packing_round",
                   split=packing_split)
    return (tile.assignments, _seven(tile.state, tile.nom_active), tile.lam, tile.objective,
            iters, tile.nodes_used)


def packing_log1p(k: torch.Tensor):
    """The dual ascent's ``log1p`` of whole-number counts ``k`` (n,) float32
    on the card: ``(ours, cuda)``, the kernel's (equal to
    ``assign.packing.log1p_counts``) and CUDA's ``log1pf`` of the same
    counts, for comparison."""
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"packing_log1p: the kernel takes CUDA tensors, got {dev}")
    n = k.shape[0] if k.dim() == 1 else -1
    p_k = _check("k", k, torch.float32, (n,), dev)
    ours = torch.empty_like(k)
    cuda = torch.empty_like(k)
    lib = build()["packing_round"]
    code = lib.kt_packing_log1p(p_k, ours.data_ptr(), cuda.data_ptr(), n,
                                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, "packing_round", code, "packing_log1p")
    launch_counts["packing_log1p"] += 1
    return ours, cuda


# ---------------------------------------------------------------------------
# the node mesh (parallel.mesh): the exchange, kernels K3 (the dry run's
# cross-shard pick) and K4 (the exchange's argmax probe)
# ---------------------------------------------------------------------------

# clock64 cycles an exchange wait may take before the kernel gives up
# (about 8.7 s at the H100's 1.98 GHz): a lost peer fails the launch
EXCHANGE_BUDGET = 1 << 34


on_device = rt.on_device


class _MeshExchange:
    """The exchange buffers of one mesh: a slot a shard on its device
    (sequence word, two payloads), an error word a card, and the launch
    epoch. Slots grow to the largest payload asked for and are zeroed only
    when allocated: the epoch makes older sequence words stale."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.words = 0
        self.slots: list[torch.Tensor] = []
        self.errors = {d: torch.zeros(1, dtype=torch.int32, device=d) for d in mesh.cards()}
        self.epoch = 0
        self.argmax: dict = {}   # K4's launch state by pieces (_ArgmaxLaunch)

    def prepare(self, words: int) -> None:
        """Room for ``words`` payload words, and a new epoch."""
        if words > self.words:
            self.words = max(words, 2 * self.words, 64)
            self.slots = [torch.zeros(16 + 2 * self.words, dtype=torch.int64, device=d)
                          for d in self.mesh.devices]
        self.epoch += 1

    def args(self, card: torch.device) -> Exchange:
        x = Exchange()
        for g, t in enumerate(self.slots):
            x.slot[g] = t.data_ptr()
        x.G = len(self.slots)
        x.words = self.words
        x.epoch = self.epoch
        x.budget = EXCHANGE_BUDGET
        x.error = self.errors[card].data_ptr()
        return x

    def check(self, what: str) -> None:
        """Wait for every card and raise if any exchange timed out."""
        for card, err in self.errors.items():
            if int(err.item()):
                err.zero_()
                raise RuntimeError(
                    f"{what}: a cross-shard exchange on {card} waited past its budget "
                    "(a peer shard did not arrive)")


_exchanges: dict[int, _MeshExchange] = {}
_peers_on: set = set()


def _mesh_exchange(mesh) -> _MeshExchange:
    """The mesh's exchange, its cards' peer access enabled (each pair was
    checked when the mesh was made; enabling is the kernel library's)."""
    if len(mesh.devices) > 8:
        raise ValueError(f"a node mesh of {len(mesh.devices)} shards: the exchange takes 8")
    lib = build()["greedy_scan"]
    cards = mesh.cards()
    for a in cards:
        for b in cards:
            if a != b and (a, b) not in _peers_on:
                with on_device(a):
                    _raise_on(lib, "greedy_scan", lib.kt_enable_peer_access(b.index),
                              f"peer access {a} -> {b}")
                _peers_on.add((a, b))
    ex = _exchanges.get(id(mesh))
    if ex is None or ex.mesh is not mesh:
        ex = _exchanges[id(mesh)] = _MeshExchange(mesh)
    return ex


def _words_for(b: rt.DeviceBatch) -> int:
    """The scan's largest exchange payload in int64 words: the normalize
    maxima, the pick with the chosen node's domains, a spread-scored pod's
    count and bitmaps, the domain sums at the start."""
    words = 7
    pa, sp = b.podaffinity, b.spread
    ra = 0 if pa is None else pa.base_sums.shape[0]
    s = 0 if sp is None else sp.domain_present.shape[0]
    words = max(words, 2 + ra + s)
    if sp is not None:
        C = sp.sig_idx.shape[1]
        D = sp.domain_present.shape[1]
        words = max(words, 1 + C * ((D + 31) // 32), s * (D + 1))
    return words


class _ArgmaxLaunch:
    """K4's launch state for one set of pieces on one mesh, kept with the
    mesh's exchange while the pieces live (it holds them): the shards'
    entries (in host memory, the kernel's parameter), one (shards, 2)
    int64 output a card (each shard's pick and its card's timeout flag),
    the row the host reads on each card, and the launches: one cooperative
    launch of G blocks when every shard is on one card, else one block a
    card."""

    def __init__(self, pieces, mesh) -> None:
        G = len(pieces)
        self.pieces = list(pieces)
        self.ptrs = [x.data_ptr() for x in pieces]
        self.structs = (ArgmaxShard * G)()
        rows: dict = {}
        for dev in mesh.devices:
            rows[dev] = rows.get(dev, 0) + 1
        outs = {dev: torch.zeros((n, 2), dtype=torch.int64, device=dev)
                for dev, n in rows.items()}
        used = dict.fromkeys(rows, 0)
        off = 0
        for g, x in enumerate(pieces):
            dev = mesh.devices[g]
            st = self.structs[g]
            st.vals = _check(f"pieces[{g}]", x, torch.int64, (x.shape[0],), dev)
            st.n, st.offset, st.g = x.shape[0], off, g
            st.out = outs[dev][used[dev]].data_ptr()
            used[dev] += 1
            off += x.shape[0]
        # each card's first shard's row: the pick and the card's flag. On
        # one card the launch's entry copies it into pinned host memory
        self.reads = [out[0] for out in outs.values()]
        cards = mesh.cards()
        self.host = self.host_ptr = None
        if len(cards) == 1:
            self.host = torch.zeros((2,), dtype=torch.int64, pin_memory=True)
            self.host_ptr = self.host.data_ptr()
            self.words = (ctypes.c_int64 * 2).from_address(self.host_ptr)
        self.lib = build()["greedy_scan"]
        self.launches = [
            (dev, torch.cuda._utils._get_device_index(dev, optional=True), ptr, coop)
            for dev, ptr, coop in (
                [(cards[0], ctypes.addressof(self.structs), 1)] if len(cards) == 1 else
                [(dev, ctypes.addressof(self.structs[g]), 0)
                 for g, dev in enumerate(mesh.devices)])]
        self.slots = None
        self.xs: list = []

    def exchanges(self, ex: _MeshExchange) -> list:
        """Each launch's Exchange entry at the current epoch (rebuilt when
        the exchange's slots were reallocated)."""
        if self.slots is not ex.slots:
            self.slots = ex.slots
            self.xs = [ex.args(dev) for dev, _, _, _ in self.launches]
        for x in self.xs:
            x.epoch = ex.epoch
        return self.xs


def shard_argmax(pieces, mesh, reps: int = 1) -> int:
    """Kernel K4: the first argmax of a node-sharded int64 vector (piece g
    on ``mesh.devices[g]``) through the scan's exchange, ``reps`` exchanges
    of the same pick (to time one round trip). Returns the global index.
    The launch state of a set of pieces is kept with the mesh's exchange,
    and the host reads each card's pick and timeout flag with one copy."""
    if reps < 1:
        raise ValueError("shard_argmax: reps >= 1")
    ex = _exchanges.get(id(mesh))
    if ex is None or ex.mesh is not mesh:
        ex = _mesh_exchange(mesh)
    key = tuple(map(id, pieces))
    st = ex.argmax.get(key)
    if st is None or any(x.data_ptr() != p for x, p in zip(pieces, st.ptrs)):
        if len(ex.argmax) >= 16:
            ex.argmax.clear()
        st = ex.argmax[key] = _ArgmaxLaunch(pieces, mesh)
    ex.prepare(2)
    current = torch.cuda.current_device()
    fn = st.lib.kt_shard_argmax
    for (dev, index, ptr, coop), x in zip(st.launches, st.exchanges(ex)):
        with contextlib.nullcontext() if index == current else on_device(dev):
            code = fn(ptr, ctypes.byref(x), len(pieces), coop, reps, st.host_ptr,
                      _raw_stream(index))
        if code:
            _raise_on(st.lib, "greedy_scan", code, "shard_argmax")
        launch_counts["shard_argmax"] += 1
    got = [list(st.words)] if st.host is not None else [row.tolist() for row in st.reads]
    if any(err for _, err in got):
        for err in ex.errors.values():
            err.zero_()
        raise RuntimeError("shard_argmax: a cross-shard exchange waited past its budget "
                           "(a peer shard did not arrive)")
    return int(got[0][0])


def sharded_dry_run(shard_args, offsets):
    """Kernel K3 after kernel B9 on each shard: every shard's dry run on
    its rows (on its card's stream), each leaving its best node and that
    node's five keys, then one warp on the first shard's card reduces the
    shards' bests by pick_node's order with -global index, reading the
    other cards' through peer pointers once their streams are done.
    Returns ``(node_idx () int32 global, victims, ok, n_pdb)``, the last
    three ``parallel.mesh.ShardedTensor``s; equal to
    ``ops.preemption.dry_run_preemption_sharded``'s plain reduction."""
    from ..parallel.mesh import ShardedTensor

    G = len(shard_args)
    structs = (PickShard * G)()
    outs, events = [], []
    for g, args in enumerate(shard_args):
        dev = args[3].device
        with on_device(dev):
            node_idx, victims, ok, n_pdb, best = _dry_run(*args)
            ev = torch.cuda.Event()
            ev.record()
        events.append(ev)
        outs.append((victims, ok, n_pdb, best))
        structs[g].best, structs[g].offset = best.data_ptr(), offsets[g]
    home = shard_args[0][3].device
    lib = build()["dry_run_preemption"]
    with on_device(home):
        stream = torch.cuda.current_stream(home)
        for ev in events[1:]:
            stream.wait_event(ev)
        node = torch.empty((), dtype=torch.int32, device=home)
        code = lib.kt_dry_run_shard_pick(ctypes.byref(structs), G, node.data_ptr(),
                                         stream.cuda_stream)
        _raise_on(lib, "dry_run_preemption", code, "shard_pick")
        launch_counts["shard_pick"] += 1
        # the shards' bests are read by the pick: they live until it ran
        node.item()
    return (node, ShardedTensor([o[0] for o in outs]), ShardedTensor([o[1] for o in outs]),
            ShardedTensor([o[2] for o in outs]))


# the combine's operations (csrc/batched_round.cu shard_combine_kernel)
MAX, SUM, OR = range(3)


def _after_all(mesh, home: torch.device) -> None:
    """Order ``home``'s current stream after every card's (a combine on
    ``home`` reads what each card's last launches wrote)."""
    for card in mesh.cards():
        if card != home:
            with on_device(card):
                ev = torch.cuda.Event()
                ev.record()
            with on_device(home):
                torch.cuda.current_stream(home).wait_event(ev)


def _before_all(mesh, home: torch.device) -> None:
    """Order every card's current stream after ``home``'s (each card reads
    what a combine on ``home`` wrote into its memory)."""
    if len(mesh.cards()) == 1:
        return
    with on_device(home):
        ev = torch.cuda.Event()
        ev.record()
    for card in mesh.cards():
        if card != home:
            with on_device(card):
                torch.cuda.current_stream(card).wait_event(ev)


def shard_combine(mesh, op: int, srcs, dsts) -> None:
    """The mesh's combine (the cross-shard reductions of the sharded
    filter_score passes and of the sharded potential mask's spread sums):
    element i of every ``srcs[g]`` (shard g's partial, on its device)
    reduced by ``op`` (``MAX``, ``SUM`` or ``OR``) and written into every
    ``dsts[g]``, in one launch on the mesh's first card reading and writing
    the others' memory through peer pointers, ordered after every card's
    stream and before each reads the results. int32 and int64 partials."""
    x = srcs[0]
    c = CombineArgs()
    for g, t in enumerate(srcs):
        c.src[g] = t.data_ptr()
    for g, t in enumerate(dsts):
        c.dst[g] = t.data_ptr()
    c.G, c.n, c.op = len(dsts), dsts[0].numel(), op
    c.elem = x.element_size()
    if (x.dtype not in (torch.int32, torch.int64)
            or any(t.dtype != x.dtype for t in list(srcs) + list(dsts))):
        raise ValueError(f"shard_combine: int32 or int64 partials of one dtype, got {x.dtype}")
    if len(srcs) != len(dsts) or any(t.numel() != c.n for t in srcs):
        raise ValueError("shard_combine: one partial a result, of one size")
    home = mesh.devices[0]
    lib = build()["batched_round"]
    _mesh_exchange(mesh)   # peer access
    _after_all(mesh, home)
    with on_device(home):
        code = lib.kt_shard_combine(ctypes.byref(c),
                                    torch.cuda.current_stream(home).cuda_stream)
    _raise_on(lib, "batched_round", code, "shard_combine")
    _before_all(mesh, home)


class _ShardScore:
    """One shard's buffers for the sharded filter_score: its arguments over
    the batch's own state, its (P, N) outputs and the partials the shards
    combine between its steps."""

    def __init__(self, b: rt.DeviceBatch, p: rt.ScoreParams) -> None:
        dev = b.alloc.device
        self.b, self.dev = b, dev
        self.a, self.keep = _score_args(b, p, "sharded filter_score",
                                        bits_blocks=b.requests.shape[0])
        P, N = self.a.P, self.a.N
        self.classes = _class_args(rt.pod_classes(b), P, dev)
        sp = b.spread
        cw = 0 if sp is None else sp.sig_idx.shape[1] * ((sp.domain_present.shape[1] + 31) // 32)
        i64 = torch.int64
        self.mask = torch.empty((P, N), dtype=torch.bool, device=dev)
        self.base = torch.empty((P, N), dtype=i64, device=dev)
        self.total = torch.empty((P, N), dtype=i64, device=dev)
        self.sc = torch.zeros((2, P), dtype=i64, device=dev)            # partial, combined
        self.bits = torch.zeros((2, P, max(cw, 1)), dtype=i64, device=dev)
        self.mx = torch.zeros((2, P, 7), dtype=i64, device=dev)
        # the spread domain sums the kernels read: combined over the shards
        self.sums = None
        if sp is not None:
            self.sums = torch.empty(
                (sp.domain_present.shape[0], sp.domain_present.shape[1] + 1), dtype=i64,
                device=dev)
            self.a.sp_sums = self.sums.data_ptr()


def _filter_score_shards(mesh, shards: list, smem: int) -> None:
    """Every shard's filter_score over its rows (``_ShardScore``), with the
    spread domain sums, the spread-scored counts and bitmaps and
    the normalize maxima combined over the shards between its steps."""
    lib = build()["filter_score"]

    def step(k, sc=None, bits=None, mx=None):
        for s in shards:
            with on_device(s.dev):
                code = lib.kt_filter_score_shard(
                    ctypes.byref(s.a), s.mask.data_ptr(), s.base.data_ptr(),
                    s.total.data_ptr(), k, 0, _ptr(sc(s) if sc else None),
                    _ptr(bits(s) if bits else None), _ptr(mx(s) if mx else None), smem,
                    *s.classes, torch.cuda.current_stream(s.dev).cuda_stream)
            _raise_on(lib, "filter_score", code, "filter_score (sharded)")
            launch_counts["filter_score"] += 1

    sp = shards[0].b.spread
    if sp is not None:
        step(0)
        parts = []
        for s in shards:
            with on_device(s.dev):
                parts.append(s.sums.clone())
        shard_combine(mesh, SUM, parts, [s.sums for s in shards])
    step(1)
    step(2, sc=lambda s: s.sc[0], bits=lambda s: s.bits[0], mx=lambda s: s.mx[0])
    if sp is not None:
        shard_combine(mesh, SUM, [s.sc[0] for s in shards], [s.sc[1] for s in shards])
        shard_combine(mesh, OR, [s.bits[0] for s in shards], [s.bits[1] for s in shards])
    step(3, sc=lambda s: s.sc[1], bits=lambda s: s.bits[1], mx=lambda s: s.mx[0])
    shard_combine(mesh, MAX, [s.mx[0] for s in shards], [s.mx[1] for s in shards])
    step(4, sc=lambda s: s.sc[1], bits=lambda s: s.bits[1], mx=lambda s: s.mx[1])


def sharded_filter_score(tiles, mesh, p: rt.ScoreParams):
    """``filter_score`` over one pod row of a sharded batch (``tiles`` its
    node columns' batches, ``mesh`` the row's node-axis mesh): each tile's
    ``(mask, total)`` over its rows, equal to the tiles' rows of the
    unsharded kernel's (the normalize maxima and the spread terms reduced
    over the row, ``_filter_score_shards``)."""
    shards = []
    for b in tiles:
        with on_device(b.alloc.device):
            shards.append(_ShardScore(b, p))
    _filter_score_shards(mesh, shards, _smem(tiles[0]))
    for s in shards:
        with on_device(s.dev):
            torch.cuda.current_stream(s.dev).synchronize()
    return [(s.mask, s.total) for s in shards]


# ---------------------------------------------------------------------------
# kernel K8: the packing solve over a pods x nodes grid (csrc/packing_round.cu);
# a node mesh is the grid of one pod row (kernel K5)
# ---------------------------------------------------------------------------


def tiled_packing_assign(sb, p: rt.ScoreParams, lam_pieces, weights: torch.Tensor,
                         max_iters: int = 0, rows_out: list | None = None):
    """Kernels K8 and K5, the packing solve over a sharded batch
    (``parallel.mesh.ShardedBatch`` on CUDA devices: a pods x nodes grid,
    K8, or a node mesh, one pod row, K5): one cooperative launch a solve on
    each card, holding the card's tiles (``kt_packing_round``; the rounds,
    each with every tile's Filter + Score of its pods against its node
    column, and the stop rule on the device). Inside each pod row the
    tiles combine the slice occupancy, the spread terms, the normalize
    maxima, the row maxima of |score|, the best utility, the tie counts and
    hashes and, at the end, the marginal utility (float32 min), the
    fragmentation (float32 sum, in column order), whether any node was used
    and the nodes used; the picks read every pod row's class rows (each
    pod's rank over every pod in queue order), each column admits the
    choosers of every pod row, and every tile commits its column's pods to
    its own copy of the column's rows and duals. The cards' launches meet
    at the mesh's exchange; the host reads each card's iterations and error
    flag once. ``lam_pieces``: each tile's (N / NG,) float32 duals (not
    written). Returns ``(assignments (P,) int32 global, final_state, lam,
    objective () float32, iters, nodes_used () int32)``, the node slots
    (pod row 0's) and λ (every tile's) as ``parallel.mesh.ShardedTensor``s,
    equal to ``assign.packing.packing_assign_tiled_plain`` and to the
    unsharded ``packing_assign`` (the objective within its float32 sums'
    order); ``rows_out`` as the plain version's."""
    from ..parallel.mesh import ShardedTensor

    P, NG, PG = sb.num_pods, sb.columns, sb.pod_rows
    cards, bpt = _tile_cards(sb, "tiled packing")
    tiles = []
    for t, (b, lam) in enumerate(zip(sb.shards, lam_pieces)):
        i, j = divmod(t, NG)
        with on_device(b.alloc.device):
            tiles.append(_SolveTile(b, sb.full_tile(t) if PG > 1 else b, p, lam, weights,
                                    sb.offsets[j], i, j, bpt))
    what = "sharded_packing" if PG == 1 else "tiled_packing"
    iters = _solve(tiles, cards, PG, NG, bpt, max_iters or P, sb.mesh, what,
                   split=packing_split)
    s0 = tiles[0]
    return (s0.assignments, _tile_slots(tiles, PG, NG, rows_out),
            ShardedTensor([s.lam for s in tiles], rows=PG), s0.objective, iters, s0.nodes_used)


def _tile_cards(sb, what: str) -> tuple[dict, int]:
    """A sharded batch's tiles by card (card -> the tiles' indices) for a
    solve, and the blocks a tile: at most 8 tiles, equal blocks of nodes and
    pods."""
    NG, PG = sb.columns, sb.pod_rows
    if PG * NG > 8:
        raise ValueError(f"{what}: {PG * NG} tiles; the solve takes 8")
    n = int(sb.shards[0].alloc.shape[0])
    pb = int(sb.shards[0].requests.shape[0])
    if list(sb.offsets) != [j * n for j in range(NG)] or list(sb.pod_offsets) != [
            i * pb for i in range(PG)]:
        raise ValueError(f"{what}: the tiles must be equal blocks of nodes and pods")
    cards: dict = {}
    for t, b in enumerate(sb.shards):
        cards.setdefault(b.alloc.device, []).append(t)
    return cards, _blocks_a_tile(cards)


def _tile_slots(tiles: list, PG: int, NG: int, rows_out: list | None) -> tuple:
    """A solve's seven state slots: the node slots of pod row 0's tiles as
    ``parallel.mesh.ShardedTensor``s, tile 0's affinity sums and
    nominations; ``rows_out``, when given, receives every pod row's node
    slots."""
    from ..assign.batched import _row_slots

    slots = [[s.state[k] for s in tiles] for k in range(6)]
    if rows_out is not None:
        rows_out.extend(_row_slots(slots[0], slots[1], slots[2], slots[3], slots[5], i, NG)
                        for i in range(PG))
    return _row_slots(slots[0], slots[1], slots[2], slots[3], slots[5], 0, NG) + (
        tiles[0].state[4], tiles[0].nom_active)


# ---------------------------------------------------------------------------
# kernels K6 and K7: the batched solve and the greedy scan on a pods x nodes
# grid (csrc/batched_round.cu, csrc/greedy_scan.cu); a node mesh is the grid
# of one pod row (kernels K2 and K1)
# ---------------------------------------------------------------------------


def tiled_batched_assign(sb, p: rt.ScoreParams, max_rounds: int = 0,
                         rounds_out: list | None = None, rows_out: list | None = None):
    """Kernels K6 and K2, the batched engine over a sharded batch
    (``parallel.mesh.ShardedBatch`` on CUDA devices: a pods x nodes grid,
    K6, or a node mesh, one pod row, K2): one cooperative launch a solve on
    each card, holding the card's tiles (``kt_batched_round``, the kernel
    of the unsharded engine; the rounds, each with every tile's Filter +
    Score of its pod classes against its node column, and the stop rule on
    the device). Inside each pod row the tiles combine the spread terms, the
    normalize maxima, the best score, the tie counts (their prefix in
    column order for the pick) and the wrapping sums of the tie weights of
    the global node indices, and the affinity increments; the ranks run
    over every pod in queue order from every pod row's class rows, each
    column admits the choosers of every pod row, and every tile commits
    its column's pods to its own copy of the column's rows, so a column's
    copies stay equal. The cards' launches meet at the mesh's exchange; the
    host reads each card's rounds and error flag once. Returns
    ``(assignments (P,) int32 global, final_state)``, the node slots from
    pod row 0's tiles, equal to
    ``assign.batched.batched_assign_tiled_plain(sb, p, max_rounds)``;
    ``rows_out`` as the plain version's."""
    P, NG, PG = sb.num_pods, sb.columns, sb.pod_rows
    if P > 1024:
        raise ValueError(f"batched_round: P={P} exceeds the solve's 1024 pods")
    cards, bpt = _tile_cards(sb, "tiled batched")
    tiles = []
    for t, b in enumerate(sb.shards):
        i, j = divmod(t, NG)
        with on_device(b.alloc.device):
            tiles.append(_BatchTile(b, sb.full_tile(t) if PG > 1 else b, p, sb.offsets[j], i, j,
                                    NG))
    what = "sharded_round" if PG == 1 else "tiled_round"
    rounds = _solve(tiles, cards, PG, NG, bpt, max_rounds or P, sb.mesh, what, "batched_round",
                    batched_split)
    if rounds_out is not None:
        rounds_out.append(rounds)
    return tiles[0].assignments, _tile_slots(tiles, PG, NG, rows_out)


def tiled_greedy_scan(sb, p: rt.ScoreParams):
    """Kernels K7 and K1, the greedy engine over a sharded batch
    (``parallel.mesh.ShardedBatch`` on CUDA devices: a pods x nodes grid,
    K7, or a node mesh, one pod row, K1): each tile's ``filter_score`` on
    its (P / PG, N / NG) block, then one ``tiled_scan`` launch (NG blocks
    of one cooperative launch on one card, or one block a card on pod row
    0's cards): node column j's block scans the pod rows in turn with each
    row's tile, exchanging each step's pick with the other columns' blocks
    at every reduction over nodes; each column keeps one running copy of
    its rows, which every pod row's step reads and takes the pick into.
    The exchange's slots are pod row 0's. Returns ``(assignments (P,)
    int32 global, final_state)``, the node-axis slots as
    ``parallel.mesh.ShardedTensor``s, equal to
    ``assign.greedy.greedy_assign_tiled_plain(sb, p)`` and to the
    unsharded engine on the whole batch."""
    from ..parallel.mesh import ShardedTensor

    mesh, NG, PG = sb.mesh, sb.columns, sb.pod_rows
    if PG * NG > 8:
        raise ValueError(f"tiled_scan: {PG} x {NG} tiles, the launch takes 8")
    smem = max(_scan_smem(b, p, "tiled_greedy_scan") for b in sb.shards)
    row0 = mesh.row(0)
    one_card = len(row0.cards()) == 1
    if not one_card and len(set(row0.devices)) != NG:
        raise ValueError("tiled_scan: pod row 0's columns share a card with another column")
    P = sb.num_pods
    cols = []
    for j in range(NG):
        b = sb.tile(0, j)
        dev = b.alloc.device
        pa, sp = b.podaffinity, b.spread
        with on_device(dev):
            cols.append(dict(
                assignments=torch.empty((P,), dtype=torch.int32, device=dev),
                req=torch.empty_like(b.requested), nz=torch.empty_like(b.nonzero_requested),
                pc=torch.empty_like(b.pod_count), ports=torch.empty_like(b.node_ports),
                touched=torch.empty((b.alloc.shape[0],), dtype=torch.uint8, device=dev),
                pa_sums=None if pa is None else torch.empty_like(pa.base_sums),
                row_total=None if pa is None else torch.empty(
                    (pa.base_sums.shape[0],), dtype=torch.int64, device=dev),
                sp_counts=None if sp is None else torch.empty_like(sp.node_count),
                ok_buf=None if sp is None
                else torch.empty((b.alloc.shape[0],), dtype=torch.uint8, device=dev),
                nom_active=None if b.nominated_pod_idx is None else torch.ones(
                    (b.nominated_pod_idx.shape[0],), dtype=torch.bool, device=dev),
            ))
    structs = (ScanShard * (PG * NG))()
    keep, words, a0 = [], 7, {}
    for t, b in enumerate(sb.shards):
        i, j = divmod(t, NG)
        dev, col = b.alloc.device, cols[j]
        with on_device(dev):
            live = (None if b.nominated_pod_idx is None
                    else torch.ones_like(b.nominated_pod_idx, dtype=torch.bool))
            mask0, base0, _ = _filter_score(b, p, want_total=False, dynamic=False,
                                            nom_active=live)
            if b.nominated_pod_idx is not None and i > 0:
                # the scan compares a nomination's pod with the row's own
                # pod index
                idx = b.nominated_pod_idx
                b = dataclasses.replace(b, nominated_pod_idx=torch.where(
                    idx >= 0, idx - sb.pod_offsets[i], -1).to(torch.int32))
            a, kp = _score_args(b, p, "tiled_greedy_scan", bits_blocks=1, nom_active=live)
        if i == 0:
            a0[j] = a
        else:
            # every pod row's step writes the column's one running copy
            for f in ("nom_active", "sp_sums", "sp_min_match", "sp_bits"):
                setattr(a, f, getattr(a0[j], f))
        st = structs[t]
        st.a = a
        st.mask0, st.base0 = mask0.data_ptr(), base0.data_ptr()
        for name in ("touched", "req", "nz", "pc", "ports", "pa_sums", "row_total",
                     "sp_counts", "ok_buf"):
            setattr(st, name, _ptr(col[name]))
        st.assignments = col["assignments"].data_ptr() + 4 * sb.pod_offsets[i]
        st.offset = sb.offsets[j]
        keep += [mask0, base0, kp, live, b]
        words = max(words, _words_for(b))
    if cols[0]["nom_active"] is not None:
        for j in range(NG):
            a0[j].nom_active = cols[j]["nom_active"].data_ptr()
            for i in range(PG):
                structs[i * NG + j].a.nom_active = cols[j]["nom_active"].data_ptr()
    ex = _mesh_exchange(row0)
    _mesh_exchange(mesh)   # peer access between every card of the grid
    ex.prepare(words)
    lib = build()["greedy_scan"]
    b0 = sb.shards[0]
    flags = (int(b0.podaffinity is not None), int(b0.spread is not None),
             int(b0.dra_score_raw is not None and p.w_dra != 0))
    if PG > 1:
        # every tile's filter_score is done before the scan reads it (a
        # node mesh's scan follows each shard's on its own stream)
        for card in mesh.cards():
            with on_device(card):
                torch.cuda.current_stream(card).synchronize()
    launches = ([(row0.devices[0], 1, -1)] if one_card
                else [(row0.devices[j], 0, j) for j in range(NG)])
    what = "sharded_scan" if PG == 1 else "tiled_scan"
    for dev, coop, colj in launches:
        x = ex.args(dev)
        with on_device(dev):
            code = lib.kt_tiled_scan(ctypes.addressof(structs), ctypes.byref(x), PG, NG, coop,
                                     colj, *flags, smem,
                                     torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, "greedy_scan", code, what)
        launch_counts[what] += 1
    ex.check(what)
    del keep
    return cols[0]["assignments"], (
        ShardedTensor([c["req"] for c in cols]), ShardedTensor([c["nz"] for c in cols]),
        ShardedTensor([c["pc"] for c in cols]), ShardedTensor([c["ports"] for c in cols]),
        None if b0.spread is None else ShardedTensor([c["sp_counts"] for c in cols], axis=1),
        cols[0]["pa_sums"], cols[0]["nom_active"],
    )
