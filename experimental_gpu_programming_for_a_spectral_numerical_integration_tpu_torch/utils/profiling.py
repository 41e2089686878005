"""Timing on the card with CUDA events.

The host returns from a launch before the device finishes, so a host clock
without a synchronize measures the enqueue.  :func:`cuda_time_ms` brackets
each repetition with CUDA events on the current stream, after warm-up
calls, and returns the median.
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["cuda_time_ms"]


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
