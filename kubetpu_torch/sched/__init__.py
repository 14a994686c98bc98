"""The scheduler runtime: the batched scheduling cycle with synchronous
binding (first slice of the port; see ``scheduler``)."""

from .scheduler import CycleTiming, Scheduler, SchedulerMetrics  # noqa: F401
