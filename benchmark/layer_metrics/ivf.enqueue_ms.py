"""Host milliseconds per batch spent queueing center blocks' device work
(the ``ivf.block`` spans: prune, select, verify, top hits and packing, a
capacity re-dispatch included), before any result is read back."""

from benchmark import spans


def read(ctx):
    return spans.span_ms_per_batch(ctx, "ivf.block")
