"""scheduler_perf-style harness of the port (direct mode)."""

from .runner import WorkloadResult, run_workload  # noqa: F401
from .workloads import TEST_CASES  # noqa: F401
