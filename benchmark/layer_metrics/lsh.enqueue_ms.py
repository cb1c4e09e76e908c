"""Host milliseconds per batch spent queueing the LSH search's center
blocks (the ``lsh.block`` spans: query codes, candidate probe, gather and
dedup, verify, top hits and packing), before any result is read back."""

from benchmark import spans


def read(ctx):
    return spans.span_ms_per_batch(ctx, "lsh.block")
