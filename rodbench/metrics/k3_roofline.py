"""K3's roofline bound for one launch of the cell's batch (``roofline.k3``) over
its mean device time per launch in the trace, in %."""

from rodbench.metrics import readers, roofline

KERNEL = "rod_shape_refined_kernel"


def read(rec):
    times = readers.kernel_times(rec.trace, KERNEL)
    if not times:
        return None
    c = rec.config
    work = roofline.k3(rec.traffic["batch"], c["n"] - 1, c["na"], c["ne"], c["iters"],
                       c["corr_iters"])
    return roofline.share_pct(work, sum(times) / len(times))
