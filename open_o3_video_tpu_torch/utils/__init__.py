"""Host utilities of the port: the metrics bus, the stage timer, profiler
traces and xlsx IO."""

from .metrics import MetricsBus
from .profiling import StageTimer, start_trace, stop_trace, trace_annotation

__all__ = ["MetricsBus", "StageTimer", "start_trace", "stop_trace", "trace_annotation"]
