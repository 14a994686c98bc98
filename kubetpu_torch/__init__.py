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

What the port runs, in direct mode (``sched.scheduler.Scheduler``,
``perf.run_workload``, ``bridge.ExtenderServer``): the default profile's
scheduling cycle on the greedy, batched and packing engines, serial or
pipelined over a node block resident on the device, with inter-pod
affinity, topology spread, preemption and nominations, the extender
webhooks, the flight recorder, the gang and topology lane, and volumes and
DynamicResources with the Reserve / Permit / PreBind lifecycle runner
(``framework.lifecycle``), and the device mesh (``parallel.mesh``: the
node axis and the pods x nodes grid on every engine, and the gang lane
under either, its group cycles unsharded as the reference's). Features of
later slices (the asynchronous API dispatcher, ...) raise
``NotImplementedError`` naming their ROADMAP item.
"""

__version__ = "0.1.0"
