"""100 (1 - union of the device's operations / traced window) in the statics cell."""

from rodbench.metrics import readers


def read(rec):
    return readers.idle_pct(rec.trace)
