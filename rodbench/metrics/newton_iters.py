"""Newton iterations per call (StaticsSolution.iterations), mean over the
traced run's calls."""


def read(rec):
    iters = rec.counters.get("newton_iterations")
    return sum(iters) / len(iters) if iters else None
