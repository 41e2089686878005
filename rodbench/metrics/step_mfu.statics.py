"""The whole call's share of the card's peak: the least time of the K1 and K2
work that a traced call launches, at the peak of its binding unit
(``roofline.ops_seconds``), over the mean call time outside the profiler,
read by the CUDA events around each call (the card's clock), in %.  The
launches per call come from the trace."""

from rodbench.metrics import readers, roofline
from rodbench.metrics.k1k2_roofline import K1, K2, work


def read(rec):
    k1, k2 = readers.kernel_times(rec.trace, K1), readers.kernel_times(rec.trace, K2)
    step = readers.mean_step_s(rec)
    if not (k1 or k2) or not step:
        return None
    per_call = work(rec, len(k1), len(k2)) * (1.0 / rec.trace.calls)
    return 100.0 * roofline.ops_seconds(per_call) / step
