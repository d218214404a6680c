"""Seconds from the process's start to the window's start: imports, the
CUDA context, the kernels' library, the corpus pixels, the pool and the
call's inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
