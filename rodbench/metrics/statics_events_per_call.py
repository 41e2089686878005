"""Device operations per traced solve_statics_batched call: the launches that
its host path makes."""


def read(rec):
    if rec.trace is None or not rec.trace.calls:
        return None
    return len(rec.trace.events) / rec.trace.calls
