"""Mean host milliseconds of one rod_shape_refined_fused call, entry to return
(its strain_rho host sync included, the wait for the results not), over the
traced run's calls outside the profiler."""

from rodbench.metrics import readers


def read(rec):
    calls = readers.untraced_calls(rec)
    if not calls:
        return None
    return 1e3 * sum(ret - start for start, ret, _ in calls) / len(calls)
