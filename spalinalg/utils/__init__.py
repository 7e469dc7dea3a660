"""Aux subsystems: metrics/roofline, profiling hooks, in-jit validation."""

from .checks import checked_call, checked_structure, determinism_audit
from .metrics import (
    DEVICE_PEAKS,
    device_peaks,
    MetricsRecorder,
    OpMetrics,
    recorder,
    roofline_model,
)
from .profiling import annotate, device_sync, trace_to

__all__ = [
    "checked_structure", "checked_call", "determinism_audit",
    "MetricsRecorder", "OpMetrics", "recorder", "roofline_model", "DEVICE_PEAKS",
    "device_peaks",
    "annotate", "trace_to", "device_sync",
]
