"""The whole call's share of the card's peak: the least time of the K3 work
that a traced call launches, at the peak of its binding unit
(``roofline.ops_seconds``), over the mean call time outside the profiler,
read by the CUDA events around each call (the card's clock), in %.  The
launches per call come from the trace."""

from rodbench.metrics import readers, roofline
from rodbench.metrics.k3_roofline import KERNEL


def read(rec):
    launches = len(readers.kernel_times(rec.trace, KERNEL))
    step = readers.mean_step_s(rec)
    if not launches or not step:
        return None
    c = rec.config
    work = roofline.k3(rec.traffic["batch"], c["n"] - 1, c["na"], c["ne"], c["iters"],
                       c["corr_iters"]) * (launches / rec.trace.calls)
    return 100.0 * roofline.ops_seconds(work) / step
