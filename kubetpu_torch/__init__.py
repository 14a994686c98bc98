"""kubetpu_torch — the PyTorch/CUDA port of kubetpu.

The JAX package ``kubetpu`` stays the reference; this package is its port to
PyTorch on an NVIDIA H100. Modules keep the reference's paths and names so a
reader finds each counterpart. Host modules (``api``, ``state``, ``queue``,
``names``) are copies of the reference's; the device path is PyTorch
(``ops``, ``framework.runtime``, ``assign``), and on a CUDA device the main
path runs the hand-written kernels of ``kernels/csrc``.

The port imports neither ``jax`` nor ``kubetpu``. Every entry point takes an
explicit ``device`` (default ``"cuda"``): a CPU device runs the plain
PyTorch versions, a CUDA device runs the kernels, and nothing probes for a
GPU or falls back from one path to the other.

This is the first slice: the default-profile greedy scheduling cycle in
direct mode (``sched.scheduler.Scheduler``, ``perf.run_workload``).
Features of later slices raise ``NotImplementedError`` naming their ROADMAP
item.
"""

__version__ = "0.1.0"
