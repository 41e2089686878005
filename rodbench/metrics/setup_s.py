"""Seconds from the start of the process to the start of the window (host clock):
imports, CUDA context, kernel libraries (built on a checkout's first run),
inputs and the warm-up calls."""


def read(rec):
    return rec.setup_s
