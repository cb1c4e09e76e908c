"""Device milliseconds per batch of the block select: the kernels whose
launch lies inside an ``ivf.select`` span (the cascade's or the flat
top-k), matched to their launch by the trace's ``correlation`` id."""

from benchmark import spans


def read(ctx):
    return spans.kernel_ms_per_batch(ctx, "ivf.select")
