"""The hand-written CUDA kernels of the main path, and their wrappers.

``csrc/filter_score.cu`` and ``csrc/greedy_scan.cu`` (both built on
``csrc/score_common.cuh``) are compiled at first use, for ``sm_90a``, one
``nvcc`` per source started together, each into a shared library with a
plain C interface that ``ctypes`` loads. No PyTorch header is compiled, so
a build takes seconds. Outputs go to ``build/kubetpu_torch_kernels/`` under
the repository root, keyed by a hash of the sources and flags.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``, launches on the
current CUDA stream, raises if the launch was refused, and adds one to its
entry of ``launch_counts``. No wrapper falls back to the plain version: the
callers (``framework.runtime.filter_score_batch``,
``assign.greedy.greedy_assign_device``) choose the plain version only for a
batch that lives on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from ..framework import config as C
from ..framework import runtime as rt

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("filter_score.cu", "greedy_scan.cu")
HEADERS = ("score_common.cuh",)
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
launch_counts = {"filter_score": 0, "greedy_scan": 0}

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
    compiler output (``-Xptxas=-v``: registers, spills, shared memory)."""
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
            n_args = {"filter_score": 5, "greedy_scan": 10}[name]
            fn.argtypes = [ctypes.c_void_p] * n_args
            fn.restype = ctypes.c_int
            err = getattr(lib, f"kt_{name}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
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
    ]


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


def _score_args(b: rt.DeviceBatch, p: rt.ScoreParams, where: str):
    """Validate the batch for the kernels and pack their argument struct.
    Returns ``(args, keepalive)``."""
    rt.check_slice_leaves(rt.batch_leaves(b), where)
    dev = b.alloc.device
    if dev.type != "cuda":
        raise ValueError(f"{where}: the kernel takes CUDA tensors, batch is on {dev}")
    if p.strategy not in _STRATEGIES:
        raise ValueError(f"{where}: unknown scoring strategy {p.strategy!r}")
    N, R = b.alloc.shape
    P = b.requests.shape[0]
    K = b.port_conflict.shape[0]
    if P > 65535:
        raise ValueError(f"{where}: P={P} exceeds the grid's y extent")
    i64, i32, u8 = torch.int64, torch.int32, torch.bool
    a = ScoreArgs()
    a.alloc = _check("alloc", b.alloc, i64, (N, R), dev)
    a.requested = _check("requested", b.requested, i64, (N, R), dev)
    a.nonzero_requested = _check("nonzero_requested", b.nonzero_requested, i64, (N, R), dev)
    a.pod_count = _check("pod_count", b.pod_count, i32, (N,), dev)
    a.allowed_pods = _check("allowed_pods", b.allowed_pods, i32, (N,), dev)
    a.node_valid = _check("node_valid", b.node_valid, u8, (N,), dev)
    a.node_ports = _check("node_ports", b.node_ports, u8, (N, K), dev)
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
    params = torch.tensor(
        list(p.fit_weights) + list(p.balanced_weights)
        + [int(s) for s in p.is_scalar] + list(p.shape_x) + list(p.shape_y),
        dtype=i64,
    ).to(dev, non_blocking=False)
    a.params = params.data_ptr()
    a.P, a.N, a.R, a.K, a.B = P, N, R, K, B
    a.strategy = _STRATEGIES[p.strategy]
    a.w_fit, a.w_balanced = p.w_fit, p.w_balanced
    a.w_na, a.w_taint, a.w_image = p.w_node_affinity, p.w_taint, p.w_image
    a.filter_fit, a.filter_ports = int(p.filter_fit), int(p.filter_ports)
    return a, params


def _raise_on(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = getattr(lib, f"kt_{name}_error")(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def _filter_score(b: rt.DeviceBatch, p: rt.ScoreParams, want_total: bool):
    """Launch ``filter_score``: ``(mask, base, total)``, ``total`` None
    unless ``want_total`` (then the normalize pass runs too)."""
    a, keep = _score_args(b, p, "filter_score")
    lib = build()["filter_score"]
    dev = b.alloc.device
    mask = torch.empty((a.P, a.N), dtype=torch.bool, device=dev)
    base = torch.empty((a.P, a.N), dtype=torch.int64, device=dev)
    total = (
        torch.empty((a.P, a.N), dtype=torch.int64, device=dev)
        if want_total else None
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.kt_filter_score(
        ctypes.byref(a), mask.data_ptr(), base.data_ptr(),
        None if total is None else total.data_ptr(), stream)
    _raise_on(lib, "filter_score", code)
    launch_counts["filter_score"] += 1
    del keep
    return mask, base, total


def filter_score(b: rt.DeviceBatch, p: rt.ScoreParams):
    """The ``filter_score`` kernel: ``(mask (P,N) bool, total (P,N) int64)``,
    equal to ``runtime.feasible_and_scores(b, p)``."""
    mask, _, total = _filter_score(b, p, want_total=True)
    return mask, total


def greedy_scan(b: rt.DeviceBatch, p: rt.ScoreParams):
    """The greedy engine on the card: ``filter_score`` scores every pair
    against the batch's starting state, then the ``greedy_scan`` kernel
    walks the pods. Returns ``(assignments (P,) int32, final_state)`` with
    the reference's seven state slots (the last three None), equal to
    ``assign.greedy.greedy_assign_plain(b, p)``."""
    mask0, base0, _ = _filter_score(b, p, want_total=False)
    a, keep = _score_args(b, p, "greedy_scan")
    lib = build()["greedy_scan"]
    dev = b.alloc.device
    assignments = torch.empty((a.P,), dtype=torch.int32, device=dev)
    req = torch.empty_like(b.requested)
    nz = torch.empty_like(b.nonzero_requested)
    pc = torch.empty_like(b.pod_count)
    ports = torch.empty_like(b.node_ports)
    touched = torch.empty((a.N,), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.kt_greedy_scan(
        ctypes.byref(a), mask0.data_ptr(), base0.data_ptr(), touched.data_ptr(),
        assignments.data_ptr(), req.data_ptr(), nz.data_ptr(), pc.data_ptr(),
        ports.data_ptr(), stream)
    _raise_on(lib, "greedy_scan", code)
    launch_counts["greedy_scan"] += 1
    del keep
    return assignments, (req, nz, pc, ports, None, None, None)
