"""Device tracing of the port: ``device_profile``.

Port of ``kubetpu/tracing.py``'s ``device_profile`` (:277), which wraps
``jax.profiler.trace``: here ``torch.profiler`` records the enclosed block's
host operations and, on a CUDA device, its kernels (CUPTI), and writes a
Chrome trace (``trace.json``, viewable in ``chrome://tracing`` or
Perfetto) into ``log_dir``. The rest of the reference's module, the
``Tracer`` of cycle spans, is ROADMAP Queue A item 15.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch


@contextmanager
def device_profile(log_dir: str):
    """Profile the enclosed block (host operations and CUDA activity) and
    export its Chrome trace to ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` sums the time by operation and
    kernel."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
