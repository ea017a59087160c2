"""setup_s: seconds from process start to the first timed request
(imports, the CUDA context, the kernel library, the pool's frames and
inputs, one warm-up request on every pool item)."""


def read(ctx):
    return ctx.setup_s
