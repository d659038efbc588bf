"""qps: queries answered in the window over the window's seconds, every
batch and every second of it (host clock)."""


def read(ctx):
    w = ctx.window
    if not w.answered or w.window_s <= 0:
        return None
    return w.answered / w.window_s
