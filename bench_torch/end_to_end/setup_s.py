"""Seconds from the start of the process to the start of the window:
imports, the kernel library's build where it is not built yet, the
seeded weights, the engine and the warm-up."""


def read(rec):
    return rec.setup_s
