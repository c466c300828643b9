"""Seconds from the process's start (the first line of `run.py`) to the
window's: imports, the kernel library (built on a cell's first run), the
coverage set, the target pool and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
