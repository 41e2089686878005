"""Timing on the card: CUDA events, and a device-time breakdown.

The host returns from a launch before the device finishes, so a host clock
without a synchronize measures the enqueue.  :func:`cuda_time_ms` brackets
each repetition with CUDA events on the current stream, after warm-up
calls, and returns the median.  :func:`device_breakdown` traces calls with
``torch.profiler`` and sums the device's own events per call.
"""

from __future__ import annotations

import collections
import statistics
import time

import torch

__all__ = ["cuda_time_ms", "device_breakdown"]


def cuda_time_ms(fn, *args, warmup: int = 3, reps: int = 10, **kwargs) -> float:
    """Median milliseconds per call of ``fn(*args, **kwargs)`` on the card.

    Raises when CUDA is not available: a device time has no CPU stand-in.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_breakdown(fn, *args, warmup: int = 3, reps: int = 10, top: int = 6,
                     **kwargs) -> dict:
    """Where one call of ``fn`` spends its time on the card.

    ``torch.profiler`` over ``reps`` calls after ``warmup`` ones: the host
    milliseconds per call (to a synchronize), the device-busy milliseconds
    per call (the sum of the device's events: kernels, copies, fills), the
    idle share ``1 - busy / host``, the device events per call, and the
    ``top`` event names by device time as ``(name, ms per call, launches
    per call)``.  Raises when CUDA is not available.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("device_breakdown needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args, **kwargs)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name][0] += evt.time_range.elapsed_us() / 1e3 / reps
            by_name[evt.name][1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(host_ms=host_ms, device_ms=busy, idle=1.0 - busy / host_ms,
                events=sum(n for _, n in by_name.values()) / reps,
                top=[(name, ms, n / reps) for name, (ms, n) in ranked])
