"""Device kernel launches per batch in the traced window, torch ops and
the port's own kernels together: the fixed cost of ``ivf.search``'s host
loop over center blocks (and of each segment's, in the segmented
engine)."""


def read(ctx):
    if not ctx.batches or not ctx.summary["kernels"]:
        return None
    return ctx.summary["kernels"] / ctx.batches
