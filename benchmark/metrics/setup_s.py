"""Seconds from the process's start to the first timed call: imports, the
CUDA context, the kernel library's build or load, and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
