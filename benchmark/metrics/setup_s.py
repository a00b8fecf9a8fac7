"""Seconds from the process's start to the first timed request or step:
imports, the CUDA context, kernel loading (a build on a checkout's first
run), the model and its seeded weights, the inputs, the warm-up (and for
training the checked steps)."""


def read(ctx):
    return ctx.setup_s
