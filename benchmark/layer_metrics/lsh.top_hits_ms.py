"""Device milliseconds per batch of the LSH search's per-center top-k over
the verified candidate slots: the kernels whose launch lies inside an
``lsh.top_hits`` span."""

from benchmark import spans


def read(ctx):
    return spans.kernel_ms_per_batch(ctx, "lsh.top_hits")
