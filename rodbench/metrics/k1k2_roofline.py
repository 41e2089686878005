"""The roofline bound of the traced K1 and K2 launches of the statics Newton
(K1 over the batch, K2 over the 3 ne curvature directions stacked into it)
over their summed device time, in %."""

from rodbench.metrics import readers, roofline

K1, K2 = "rod_shape_fused_kernel", "picard_correction_kernel"


def work(rec, k1_launches: int, k2_launches: int) -> roofline.Work:
    c, b, n1 = rec.config, rec.traffic["batch"], rec.config["n"] - 1
    return (roofline.k1(b, n1, c["na"], c["ne"], c["iters"]) * k1_launches
            + roofline.k2(3 * c["ne"] * b, n1, c["na"] * c["ne"], c["ne"], c["jac_iters"])
            * k2_launches)


def read(rec):
    k1, k2 = readers.kernel_times(rec.trace, K1), readers.kernel_times(rec.trace, K2)
    if not k1 and not k2:
        return None
    return roofline.share_pct(work(rec, len(k1), len(k2)), sum(k1) + sum(k2))
