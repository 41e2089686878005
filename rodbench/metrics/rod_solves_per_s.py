"""Rods whose refined shape (Q, r) came back, over the whole window (host clock)."""


def read(rec):
    return rec.items / rec.window_s if rec.window_s > 0 else None
