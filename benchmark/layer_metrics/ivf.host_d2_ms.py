"""Host milliseconds per batch in ``ivf.search``'s d² of the returned hits
(the ``ivf.host_d2`` spans): the numpy recompute from the host k-mers, or
the slice of the shipped d² where the buffer carried it."""

from benchmark import spans


def read(ctx):
    return spans.span_ms_per_batch(ctx, "ivf.host_d2")
