"""Seconds from the start of the process to the window's first frame:
imports, the frame bank, the engine, loading the kernel library (building
it in a checkout's first run) and the warm-up run."""


def read(r):
    return r.setup_s
