"""What several metric readers take from a run's records."""

from __future__ import annotations


def kernel_times(trace, kernel: str) -> list:
    """Seconds of each traced launch of the CUDA kernel ``kernel`` (its name
    without template arguments)."""
    if trace is None:
        return []
    return [e - s for name, s, e in trace.events if name.split("<", 1)[0] == kernel]


def idle_pct(trace) -> float | None:
    """100 (1 - union of the device's operations / traced window)."""
    if trace is None or not trace.window_s > 0 or not trace.busy_s > 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def untraced_calls(rec) -> list:
    """``(start, return, done)`` of the window's calls outside the profiler."""
    return [c for i, c in enumerate(rec.calls) if i not in rec.profiled]


def mean_step_s(rec) -> float | None:
    """Mean seconds from a call to its results ready, outside the profiler, by
    the CUDA events around each call (the card's own clock)."""
    lat = [ms for i, ms in enumerate(rec.latencies_ms) if i not in rec.profiled]
    if not lat:
        return None
    return 1e-3 * sum(lat) / len(lat)
