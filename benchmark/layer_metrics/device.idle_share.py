"""The device's idle share of the traced window: 1 - (union of kernel,
copy and memset intervals) / the window's wall time."""


def read(ctx):
    if not ctx.window_s > 0 or not ctx.summary["busy_s"] > 0:
        return None
    return max(0.0, 1.0 - ctx.summary["busy_s"] / ctx.window_s)
