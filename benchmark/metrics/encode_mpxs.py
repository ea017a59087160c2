"""encode_mpxs: every pixel encoded in the window over the window's time
(host clock, from the first request's dispatch to the last one's end)."""


def read(ctx):
    w = ctx.window
    if w.seconds <= 0 or w.pixels <= 0:
        return None
    return w.pixels / 1e6 / w.seconds
