"""setup_s: from the start of the process (of the launcher, on several
cards) to the first timed call: imports, CUDA init, the kernel library's
load (or build, in a checkout's first run), the forest, the inputs and the
warm-up."""


def read(ctx):
    return ctx.setup_s
